// Scaled, masked softmax for Hopper (sm_90a): the whole-row kernel and the
// two-pass long-row kernels, each in a causal and a padding-masked variant.
//
// fused_softmax_causal replaces
// apex_tpu/transformer/functional/fused_softmax.py:104 _causal_kernel
// (launched by _pallas_causal, :128); fused_softmax_masked replaces :119
// _masked_kernel (launched by _pallas_masked, :254); fused_softmax_stats
// and fused_softmax_apply replace :160 _stats_kernel and :195
// _apply_kernel (launched by _pallas_blocked, :208). Per row of x, whose
// last two dims are [sq, sk], in fp32:
//   s = x * scale
//   s = -10000 where masked        causal: col > row + (sk - sq);
//                                  masked: mask[..., row, col] != 0
//   y = exp(s - max(s)) / sum(exp(s - max(s)))      stored in x's dtype
// The fill is -10000, not -inf, exactly as the reference: a masked element
// keeps its exp(-10000 - max), and a fully masked row comes out uniform.
// The whole-row kernel takes rows up to sk = 16384 (the reference's
// _WHOLE_ROW_MAX_SK); longer rows take the two passes, which hold no row.
//
// Whole row. Bound: bytes. y is written whole, but x is needed only where
// unmasked: a masked element's output is exp(-10000 - max) / sum whatever
// x holds.
// For GPT-2's causal [128, 1024, 1024] bf16 that is 134 MB of reads and
// 268 MB of writes, 0.120 ms at 3.35 TB/s; about six flops an element.
//
// Design: a row belongs to row_threads threads (a power of two from one
// warp to kMaxRowThreads), each holding at most kMaxValues fp32 values of
// it in registers (thread t takes the 16-byte vectors t + k * row_threads),
// so x leaves device memory at most once and y is written once. At GPT-2's
// sk = 1024 in bf16 one warp owns a row, 4 vectors a lane, and a block of
// kRowBlock threads holds 8 rows. The row max and the sum of exponentials
// are warp shuffles; a row of several warps joins them in one
// shared-memory step. The wrapper's _softmax_plan chooses the vector
// width, row_threads and the rows a block. 16-byte vector loads and
// stores when sk and the pointers allow them, a scalar path otherwise.
// Each exponential is multiplied by 1 / sum, within an fp32 ulp of the
// reference's division: an IEEE division an element took a sixth of the
// causal kernel's time (0.190 against 0.157 ms at GPT-2's shape on an
// H100, chip_smoke.py's check_softmax).
//
// Causal rows skip the masked keys: a vector whose columns all lie past
// q + (sk - sq) is not loaded. Its elements count as the fill: the max
// takes -10000 when a row has one, the sum adds count * exp(-10000 - max)
// (computed, never assumed 0), and each stores exp(-10000 - max) / sum,
// the value a loaded masked element gets. The vector that straddles
// the diagonal is loaded and filled per element. So a row with no
// unmasked key (sq > sk) comes out uniform 1/sk, and masked keys keep
// their weight when the unmasked scores sit near -10000. The padding mask
// is read through four element strides (zero on broadcast dims), so a
// [b, 1, 1, sk] padding mask is never expanded to x's shape; the causal
// mask is computed from the row and column indices.
//
// Long rows. The stats pass writes per row m = max(s) and l = sum(exp(s -
// m)) in fp32; the apply pass writes y = exp(s - m) / l (a division, as
// the reference). Bound: bytes, and x is needed twice: the function's
// least traffic is the unmasked reads of x and all of y (causal [16, 2048,
// 32768] bf16: 4.2 GB, 1.26 ms at 3.35 TB/s), the pair's is that plus a
// second read of the unmasked x, so it can reach about 67% of the
// function's bound. Design: one block per row for each pass, 16-byte
// vectors strided over the threads; the threads a block are the launch
// plan (apex_tpu_torch.tuning.geometry; untuned 256). In the stats pass each thread keeps
// its own online (m, l), taking the max of a whole vector before it
// rescales, then the block merges the threads' pairs by shuffles and one
// shared-memory step. Every merge keeps the reference's -inf rule: when
// the new max is -inf (every value so far -inf), shift by 0, so exp(-inf
// - -inf) never makes a NaN and l stays 0. The fill positions and the
// mask's broadcast strides are the whole-row kernel's.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRowBlock = 256;        // a whole-row block of several rows
constexpr int kMaxRowThreads = 512;   // most threads of one whole row
constexpr int kMaxValues = 32;        // fp32 values a thread holds
constexpr int kMaxSk = kMaxRowThreads * kMaxValues;  // _WHOLE_ROW_MAX_SK
constexpr float kMaskFill = -10000.f;

// strides, in elements, of a mask viewed as [d0, d1, sq, sk] beside x
struct MaskView {
  const uint8_t* ptr;
  int64_t d1;
  int64_t s0, s1, s2, s3;
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(*p);
  } else {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_float(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_float<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The mask's bytes of row `row` (query q) of x, null when causal.
template <bool kCausal>
__device__ __forceinline__ const uint8_t* mask_row(const MaskView& mask,
                                                   int64_t row, int sq, int q) {
  if (kCausal) return nullptr;
  const int64_t lead = row / sq;
  return mask.ptr + (lead / mask.d1) * mask.s0 + (lead % mask.d1) * mask.s1 +
         static_cast<int64_t>(q) * mask.s2;
}

// v = x * scale, or the fill where column c of row q is masked
template <bool kCausal>
__device__ __forceinline__ float filled(float v, float scale,
                                        const uint8_t* mr, const MaskView& mask,
                                        int q, int sq, int sk, int c) {
  const bool masked =
      kCausal ? c > q + (sk - sq) : mr[c * mask.s3] != 0;
  return masked ? kMaskFill : v * scale;
}

// V elements per load (16 bytes, or 1 on the scalar path). blockDim.x =
// rows_per_block * row_threads <= kBound; row slot g = threadIdx.x /
// row_threads takes row blockIdx.x * rows_per_block + g, and its thread t
// the vectors t + k * row_threads, k < kMaxValues / V, below sk / V.
template <typename T, int V, bool kCausal, int kBound>
__global__ void __launch_bounds__(kBound)
    softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                        MaskView mask, int64_t rows, int sq, int sk,
                        float scale, int row_threads) {
  constexpr int NV = kMaxValues / V;
  __shared__ float red_max[kBound / 32], red_sum[kBound / 32];
  const int slots = blockDim.x / row_threads;
  const int g = threadIdx.x / row_threads;
  const int t = threadIdx.x - g * row_threads;
  const int warps = row_threads >> 5;  // warps of one row
  const int64_t row = static_cast<int64_t>(blockIdx.x) * slots + g;
  const bool live = row < rows;
  const int q = live ? static_cast<int>(row % sq) : 0;
  const T* xr = x + (live ? row : 0) * sk;
  T* yr = y + row * sk;
  const uint8_t* mr = live ? mask_row<kCausal>(mask, row, sq, q) : nullptr;
  const int nvec = live ? sk / V : 0;
  // causal: vectors from `loaded` on lie wholly past the diagonal
  // (columns > q + sk - sq) and are not read
  int loaded = nvec;
  if (kCausal) {
    const int last = q + (sk - sq);  // the last unmasked column
    loaded = last < 0 ? 0 : min(nvec, last / V + 1);
  }

  float v[NV][V];
  float mx = -INFINITY;
  int skipped = 0;  // masked elements of this thread left unread
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * row_threads;
    if (i < loaded) {
      load<T, V>(xr + static_cast<int64_t>(i) * V, v[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[k][j] = filled<kCausal>(v[k][j], scale, mr, mask, q, sq, sk,
                                  i * V + j);
        mx = fmaxf(mx, v[k][j]);
      }
    } else if (i < nvec) {
      skipped += V;
    }
  }
  if (skipped > 0) mx = fmaxf(mx, kMaskFill);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (warps > 1) {  // uniform: one shared-memory step joins the warps
    if ((threadIdx.x & 31) == 0) red_max[threadIdx.x >> 5] = mx;
    __syncthreads();
    for (int k = 0; k < warps; ++k) mx = fmaxf(mx, red_max[g * warps + k]);
  }

  const float e_fill = expf(kMaskFill - mx);
  float sum = static_cast<float>(skipped) * e_fill;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (t + k * row_threads < loaded) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[k][j] = expf(v[k][j] - mx);
        sum += v[k][j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (warps > 1) {
    if ((threadIdx.x & 31) == 0) red_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    sum = 0.f;
    for (int k = 0; k < warps; ++k) sum += red_sum[g * warps + k];
  }

  const float inv = 1.f / sum;
  const float y_fill = e_fill * inv;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * row_threads;
    if (i < loaded) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = v[k][j] * inv;
    } else if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = y_fill;
    }
    if (i < nvec) store<T, V>(yr + static_cast<int64_t>(i) * V, v[k]);
  }
}

// ------------------------------------------------- long rows: two passes

// (m, l) <- the stats of the union of (m, l) and (m2, l2), shifting by 0
// when the new max is -inf (the reference's m_safe, fused_softmax.py:184)
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2,
                                            float l2) {
  const float mn = fmaxf(m, m2);
  const float shift = isfinite(mn) ? mn : 0.f;
  l = l * expf(m - shift) + l2 * expf(m2 - shift);
  m = mn;
}

template <typename T, int V, bool kCausal, int kThreads>
__global__ void __launch_bounds__(kThreads)
    softmax_stats_kernel(const T* __restrict__ x, MaskView mask, int sq,
                         int sk, float scale, float* __restrict__ m_out,
                         float* __restrict__ l_out) {
  const int64_t row = blockIdx.x;
  const int q = static_cast<int>(row % sq);
  const T* xr = x + row * sk;
  const uint8_t* mr = mask_row<kCausal>(mask, row, sq, q);
  const int nvec = sk / V;
  float m = -INFINITY, l = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load<T, V>(xr + static_cast<int64_t>(i) * V, v);
    float vmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = filled<kCausal>(v[j], scale, mr, mask, q, sq, sk, i * V + j);
      vmax = fmaxf(vmax, v[j]);
    }
    const float mn = fmaxf(m, vmax);
    const float shift = isfinite(mn) ? mn : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) sum += expf(v[j] - shift);
    l = l * expf(m - shift) + sum;
    m = mn;
  }
  for (int off = 16; off > 0; off >>= 1)
    merge_stats(m, l, __shfl_xor_sync(0xffffffffu, m, off),
                __shfl_xor_sync(0xffffffffu, l, off));
  __shared__ float part_m[32], part_l[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < static_cast<int>(blockDim.x >> 5);
    m = live ? part_m[lane] : -INFINITY;
    l = live ? part_l[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      merge_stats(m, l, __shfl_xor_sync(0xffffffffu, m, off),
                  __shfl_xor_sync(0xffffffffu, l, off));
    if (lane == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

template <typename T, int V, bool kCausal, int kThreads>
__global__ void __launch_bounds__(kThreads)
    softmax_apply_kernel(const T* __restrict__ x, MaskView mask, int sq,
                         int sk, float scale, const float* __restrict__ m_in,
                         const float* __restrict__ l_in, T* __restrict__ y) {
  const int64_t row = blockIdx.x;
  const int q = static_cast<int>(row % sq);
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const uint8_t* mr = mask_row<kCausal>(mask, row, sq, q);
  const float m = m_in[row], l = l_in[row];
  const int nvec = sk / V;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load<T, V>(xr + static_cast<int64_t>(i) * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = expf(filled<kCausal>(v[j], scale, mr, mask, q, sq, sk,
                                  i * V + j) - m) / l;
    store<T, V>(yr + static_cast<int64_t>(i) * V, v);
  }
}

// the stats pass (y null) or the apply pass over rows of x, kThreads
// threads a row's block
template <typename T, bool kCausal, int kThreads>
cudaError_t launch_blocked_t(const void* x, MaskView mask, float* m, float* l,
                             void* y, int64_t rows, int sq, int sk,
                             float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = sk % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (y == nullptr) {
    if (vec)
      softmax_stats_kernel<T, V, kCausal, kThreads><<<rows, kThreads, 0, stream>>>(xp, mask, sq, sk, scale, m, l);
    else
      softmax_stats_kernel<T, 1, kCausal, kThreads><<<rows, kThreads, 0, stream>>>(xp, mask, sq, sk, scale, m, l);
  } else if (vec) {
    softmax_apply_kernel<T, V, kCausal, kThreads><<<rows, kThreads, 0, stream>>>(xp, mask, sq, sk, scale, m, l, yp);
  } else {
    softmax_apply_kernel<T, 1, kCausal, kThreads><<<rows, kThreads, 0, stream>>>(xp, mask, sq, sk, scale, m, l, yp);
  }
  return cudaGetLastError();
}

// the launch plan: threads a row's block, 128, 256, 512 or 1024 (the
// compiled instances; the reductions' shared arrays hold 32 warps)
template <typename T, bool kCausal>
cudaError_t launch_blocked(const void* x, MaskView mask, float* m, float* l,
                           void* y, int64_t rows, int sq, int sk, float scale,
                           int threads, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch_blocked_t<T, kCausal, 128>(x, mask, m, l, y, rows, sq, sk, scale, stream);
    case 256: return launch_blocked_t<T, kCausal, 256>(x, mask, m, l, y, rows, sq, sk, scale, stream);
    case 512: return launch_blocked_t<T, kCausal, 512>(x, mask, m, l, y, rows, sq, sk, scale, stream);
    case 1024: return launch_blocked_t<T, kCausal, 1024>(x, mask, m, l, y, rows, sq, sk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kCausal>
int dispatch_blocked(const void* x, MaskView mask, float* m, float* l,
                     void* y, long long rows, int sq, int sk, float scale,
                     int dtype, int threads, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (sq < 1 || sk < 1 || rows % sq != 0 || rows > 0x7fffffffLL ||
      m == nullptr || l == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_blocked<float, kCausal>(x, mask, m, l, y, rows, sq, sk, scale, threads, s);
    case kBFloat16: return launch_blocked<__nv_bfloat16, kCausal>(x, mask, m, l, y, rows, sq, sk, scale, threads, s);
    case kFloat16: return launch_blocked<__half, kCausal>(x, mask, m, l, y, rows, sq, sk, scale, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

int blocked(const void* x, const void* mask, float* m, float* l, void* y,
            long long rows, int sq, int sk, long long d1, long long s0,
            long long s1, long long s2, long long s3, float scale, int dtype,
            int threads, void* stream) {
  if (mask == nullptr)
    return dispatch_blocked<true>(x, MaskView{nullptr, 1, 0, 0, 0, 0}, m, l,
                                  y, rows, sq, sk, scale, dtype, threads,
                                  stream);
  if (d1 < 1) return cudaErrorInvalidValue;
  return dispatch_blocked<false>(
      x, MaskView{static_cast<const uint8_t*>(mask), d1, s0, s1, s2, s3}, m,
      l, y, rows, sq, sk, scale, dtype, threads, stream);
}

// ------------------------------------------------------------ whole rows

// The launch plan (the wrapper's _softmax_plan): `vec` elements a load
// (16 bytes' worth, or 1), row_threads threads a row, rows_per_block
// rows a block.
struct RowPlan {
  int vec, row_threads, rows_per_block;
};

template <typename T, int V, bool kCausal>
cudaError_t launch_rows(const T* x, T* y, MaskView mask, int64_t rows,
                        int sq, int sk, float scale, const RowPlan& pl,
                        cudaStream_t stream) {
  const int threads = pl.rows_per_block * pl.row_threads;
  const int64_t blocks = (rows + pl.rows_per_block - 1) / pl.rows_per_block;
  if (threads <= kRowBlock)
    softmax_rows_kernel<T, V, kCausal, kRowBlock><<<blocks, threads, 0, stream>>>(
        x, y, mask, rows, sq, sk, scale, pl.row_threads);
  else
    softmax_rows_kernel<T, V, kCausal, kMaxRowThreads><<<blocks, threads, 0, stream>>>(
        x, y, mask, rows, sq, sk, scale, pl.row_threads);
  return cudaGetLastError();
}

template <typename T, bool kCausal>
cudaError_t launch(const void* x, void* y, MaskView mask, int64_t rows,
                   int sq, int sk, float scale, const RowPlan& pl,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int t = pl.row_threads;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if ((pl.vec != 1 && !(pl.vec == V && sk % V == 0 && aligned)) || t < 32 ||
      t > kMaxRowThreads || (t & (t - 1)) != 0 || pl.rows_per_block < 1 ||
      pl.rows_per_block * t > kMaxRowThreads ||
      sk / pl.vec > t * (kMaxValues / pl.vec))
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (pl.vec == V)
    return launch_rows<T, V, kCausal>(xp, yp, mask, rows, sq, sk, scale, pl, stream);
  return launch_rows<T, 1, kCausal>(xp, yp, mask, rows, sq, sk, scale, pl, stream);
}

template <bool kCausal>
int dispatch(const void* x, void* y, MaskView mask, long long rows, int sq,
             int sk, float scale, int dtype, const RowPlan& pl,
             void* stream) {
  if (rows == 0) return cudaSuccess;
  if (sq < 1 || sk < 1 || sk > kMaxSk || rows % sq != 0 ||
      rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float, kCausal>(x, y, mask, rows, sq, sk, scale, pl, s);
    case kBFloat16: return launch<__nv_bfloat16, kCausal>(x, y, mask, rows, sq, sk, scale, pl, s);
    case kFloat16: return launch<__half, kCausal>(x, y, mask, rows, sq, sk, scale, pl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y contiguous, rows = (product of the leading dims) * sq rows of sk
// elements in dtype; 1 <= sk <= 16384 (longer rows: the two passes below);
// vec, row_threads and rows_per_block: the launch plan (RowPlan), checked
// against sk and the pointers.
extern "C" int fused_softmax_causal(const void* x, void* y, long long rows,
                                    int sq, int sk, float scale, int dtype,
                                    int vec, int row_threads,
                                    int rows_per_block, void* stream) {
  return dispatch<true>(x, y, MaskView{nullptr, 1, 0, 0, 0, 0}, rows, sq, sk,
                        scale, dtype, RowPlan{vec, row_threads, rows_per_block},
                        stream);
}

// As fused_softmax_causal, with a one-byte boolean mask (nonzero = masked)
// read at mask + i0*s0 + i1*s1 + q*s2 + c*s3 for x viewed as
// [rows / (d1 * sq), d1, sq, sk].
extern "C" int fused_softmax_masked(const void* x, const void* mask, void* y,
                                    long long rows, int sq, int sk,
                                    long long d1, long long s0, long long s1,
                                    long long s2, long long s3, float scale,
                                    int dtype, int vec, int row_threads,
                                    int rows_per_block, void* stream) {
  if (mask == nullptr || d1 < 1) return cudaErrorInvalidValue;
  return dispatch<false>(
      x, y, MaskView{static_cast<const uint8_t*>(mask), d1, s0, s1, s2, s3},
      rows, sq, sk, scale, dtype, RowPlan{vec, row_threads, rows_per_block},
      stream);
}

// The long-row passes, for any sk >= 1: a null mask is the causal variant,
// else the mask is read as for fused_softmax_masked. The stats pass writes
// one fp32 m and l per row; the apply pass reads them and writes y.
// threads: a row's block (128, 256, 512 or 1024; untuned 256),
// cudaErrorInvalidValue for any other.
extern "C" int fused_softmax_stats(const void* x, const void* mask, void* m,
                                   void* l, long long rows, int sq, int sk,
                                   long long d1, long long s0, long long s1,
                                   long long s2, long long s3, float scale,
                                   int dtype, int threads, void* stream) {
  return blocked(x, mask, static_cast<float*>(m), static_cast<float*>(l),
                 nullptr, rows, sq, sk, d1, s0, s1, s2, s3, scale, dtype,
                 threads, stream);
}

extern "C" int fused_softmax_apply(const void* x, const void* mask,
                                   const void* m, const void* l, void* y,
                                   long long rows, int sq, int sk,
                                   long long d1, long long s0, long long s1,
                                   long long s2, long long s3, float scale,
                                   int dtype, int threads, void* stream) {
  if (y == nullptr) return cudaErrorInvalidValue;
  return blocked(x, mask, const_cast<float*>(static_cast<const float*>(m)),
                 const_cast<float*>(static_cast<const float*>(l)), y, rows,
                 sq, sk, d1, s0, s1, s2, s3, scale, dtype, threads, stream);
}
