// Row normalisation for Hopper (sm_90a): the one source of RMSNorm
// (rms_norm.cu) and LayerNorm (layer_norm.cu), forward and backward.
// kCentred selects LayerNorm: the mean, its m1 term in dx, the bias and db
// exist only then. Per row of x [rows, h], in fp32, with xhat the
// normalised row and gw = dy * w (dy without an affine weight):
//
//   RMSNorm    rstd = rsqrt(mean(x^2) + eps)            xhat = x * rstd
//              y    = xhat * w
//              dx   = rstd * (gw - xhat * mean(gw * xhat))
//              dw   = sum over rows of dy * xhat
//   LayerNorm  mu   = mean(x)
//              rstd = rsqrt(mean((x - mu)^2) + eps)     xhat = (x - mu) * rstd
//              y    = xhat * w + b
//              dx   = rstd * (gw - mean(gw) - xhat * mean(gw * xhat))
//              dw, db = sums over rows of dy * xhat and of dy
//
// y and dx are stored in x's dtype, dw and db (summed in fp32) in w's; the
// forward writes rstd (and mu) [rows] in fp32, as the TPU kernels save
// them. LayerNorm's variance is the mean of squared centred values, taken
// after the mean, in the TPU kernel's order: never E[x^2] - mu^2.
//
// Forward, row-register path (fwd_rows_kernel), for h a multiple of the
// 16-byte vector V and 16-byte aligned pointers, up to kMaxRowThreads *
// kRowVecs vectors a row: a row belongs to row_threads threads (one warp
// up to 32 * kRowVecs vectors; more threads when there are few rows, down
// to a vector a thread), each holding its vectors of x in registers from
// the load to the store of y, so device memory sees x once and no second
// pass asks L1 for it. The row's sums are warp shuffles, plus one
// shared-memory step when a row spans several warps: LayerNorm's mean
// first, then the mean of the centred squares from the same registers.
// The affine params are read as 16-byte vectors (two for bf16 x with fp32
// params) where y is made; rows after the first find them in L1 or L2.
// Holding a thread's w and b in registers across the rows it takes cost
// LayerNorm 90 registers a thread (64 this way), a third of the warps an
// SM, and BERT's 4096 x 768 ran slower on an H100. Slot g of block b
// takes rows (b * rows_per_block + g) + k * blocks * rows_per_block. The
// wrapper's _fwd_plan chooses row_threads, rows_per_block and blocks.
//
// Forward, loop path (fwd_kernel), for every other h, unaligned pointers
// and rows wider than the register path holds: one block per row, 16-byte
// vector loads and stores when h and the row pointers allow them (a scalar
// path otherwise, so any h and any row count work: there is no padding to
// a row block, as the TPU's _pad_rows needs); fp32 warp-shuffle reductions,
// then one shared-memory step across warps. The later passes over a row
// (LayerNorm's centred squares, the output) find it in L1/L2. The TPU's
// (8, 128) row tiles are not carried over on either path.
//
// The backward is bound by bytes too (x and dy read, dx written), and its
// dw (and db) are sums across all rows, which the TPU kernels carry in
// (1, h) blocks from grid step to grid step. Hopper's blocks run in no
// order and share nothing, so those sums take two passes instead of
// atomics (whose order, and so whose rounding, would change from run to
// run), and every count and order below is a constant of the code and the
// shape, never of the card: dw and db are the same on every run and card.
//
// Backward, row-register path (bwd_rows_kernel), for the same rows as the
// forward's: a row belongs to row_threads threads (one warp up to 32 *
// kRowVecs vectors: h = 1024 in bf16 is 4 vectors a lane), each holding
// at most kRowVecs vectors of x and of dy in registers from the load to
// the store of dx, so device memory sees x and dy once. Both row sums are
// warp shuffles; a row of several warps joins them in one shared-memory
// step. A block of kRowBlock threads holds rows_per_block such rows;
// `blocks` blocks walk the rows, slot g of block b taking rows (b *
// rows_per_block + g) + k * blocks * rows_per_block. Each thread keeps
// the fp32 dw (db) sums of the columns it owns, the same on every row, in
// registers; the block's row slots join them in slot order into one
// partial row of the [blocks, kAcc * h] fp32 buffer. The wrapper's _bwd_plan chooses row_threads, rows_per_block
// and blocks. In bf16 a thread's 64 dw and db sums and 8 vectors take the
// 128 registers that let two blocks share an SM; loading the next row
// before this row's arithmetic took ~45 more, one block an SM, and ran
// slower (0.042 against 0.032 ms at 8192 x 1024 on an H100).
//
// Backward, loop path (bwd_kernel), for every other h: `blocks` blocks of
// up to 1024 threads walk every blocks-th row and keep the column sums in
// shared memory (h floats, 2h with db).
//
// Either way column_sum_kernel then sums the partial rows down their
// columns: slice s of kSumSlices adds rows s, s + kSumSlices, ... in
// order, then the slices are added in order.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace row_norm {

constexpr int kMaxThreads = 1024;
constexpr int kRowBlock = 256;       // threads of a block holding several rows
constexpr int kMaxRowThreads = 512;  // threads of one row on the register path
constexpr int kRowVecs = 4;          // 16-byte vectors of x (and of dy) a thread
constexpr int kSumSlices = 32;       // row slices of the column-sum pass

template <typename TW>
__device__ __forceinline__ float param_at(const TW* p, int i, float none) {
  return p == nullptr ? none : to_float(p[i]);
}

template <bool kCentred>
__device__ __forceinline__ float centre(float v, float mean) {
  if constexpr (kCentred) return v - mean;
  return v;
}

// xhat * w (+ b): the affine step of the forward
template <bool kCentred, typename TW>
__device__ __forceinline__ float scale_shift(float xh, const TW* w,
                                             const TW* b, int c) {
  if constexpr (kCentred) return xh * param_at(w, c, 1.f) + param_at(b, c, 0.f);
  return xh * param_at(w, c, 1.f);
}

template <typename TX>
bool vec_ok(int h, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(TX);
  if (h % V != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// A launch plan (the wrapper's _fwd_plan and _bwd_plan). On the register
// path (registers != 0) row_threads threads a row, rows_per_block rows a
// block and `blocks` blocks that walk the rows; on the loop path
// row_threads threads a block and rows_per_block 1, with a block a row in
// the forward and `blocks` blocks (and as many partial rows) in the
// backward.
struct Plan {
  int row_threads, rows_per_block, blocks, registers;
};

// whether a register-path plan fits rows of h elements of TX at the
// pointers ptrs, each of which must be 16-byte aligned
template <typename TX>
bool rows_plan_ok(const Plan& pl, int rows, int h,
                  std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(TX);
  const int t = pl.row_threads;
  const bool pow2 = t >= 32 && t <= kMaxRowThreads && (t & (t - 1)) == 0;
  return pow2 && pl.rows_per_block >= 1 &&
         pl.rows_per_block * t <= kMaxRowThreads && vec_ok<TX>(h, ptrs) &&
         h / V <= t * kRowVecs && pl.blocks >= 1 &&
         pl.blocks <= (rows + pl.rows_per_block - 1) / pl.rows_per_block;
}

// v summed over the row_threads threads of each row slot, returned to
// all of them: a warp-shuffle butterfly (every lane ends with the same
// bits), then, when a row spans several warps (a power of two, at most
// 16), one step through red: lane k of every warp of the row takes warp
// k's sum and the same butterfly joins them. warps is uniform over the
// block, and every thread must call then; the caller alternates red
// between two buffers from one call to the next, so a call's writes
// never meet the previous call's reads. (Summing the 16 warp sums of a
// 512-thread row one after another in each thread made a decode step's
// 8 x 4096 RMSNorm slower than one block a row with a block-wide sum.)
__device__ __forceinline__ float row_sum(float v, float* red, int warps,
                                         int g) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (warps == 1) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < warps ? red[g * warps + lane] : 0.f;
  for (int off = warps >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// p[0, V) of an affine param as fp32, in loads of up to 16 bytes (one
// 8-byte load for fp32 x with 16-bit params; a vector of bf16 x with fp32
// params spans two 16-byte vectors of them); p is aligned to V *
// sizeof(TW) bytes (a multiple of 8)
template <typename TW, int V>
__device__ __forceinline__ void load_params(const TW* __restrict__ p,
                                            float (&out)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(TW));
  if constexpr (kBytes % 16 == 0) {
    constexpr int E = 16 / sizeof(TW);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) out[c * E + j] = to_float(e[j]);
    }
  } else {
    static_assert(kBytes == 8, "a vector of params is 8 or 16n bytes");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_float(e[j]);
  }
}

// The forward's register path. blockDim.x = rows_per_block * row_threads,
// row slot g = threadIdx.x / row_threads; thread t of a row owns the
// vectors t + k * row_threads, k < kRowVecs, that lie below h / V. w (and
// b) may be null (no affine); mu is written only when kCentred.
template <bool kCentred, typename TX, typename TW>
__global__ void __launch_bounds__(kMaxRowThreads)
    fwd_rows_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const TW* __restrict__ b, TX* __restrict__ y,
                    float* __restrict__ mu, float* __restrict__ rstd,
                    int rows, int h, int row_threads, float eps) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  // per join parity and warp: the warp's partial sum
  __shared__ float red[2][kMaxRowThreads / 32];
  const int slots = blockDim.x / row_threads;
  const int g = threadIdx.x / row_threads;
  const int t = threadIdx.x - g * row_threads;
  const int warps = row_threads >> 5;  // warps of one row
  const int nvec = h / V;
  const float hf = static_cast<float>(h);
  const bool affine = w != nullptr;

  int parity = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * slots;
  // the bound is on the block's first row, so every thread of the block
  // runs the same iterations and reaches the same barriers
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * slots; base < rows;
       base += step) {
    const int64_t row = base + g;
    const bool live = row < rows;
    uint4 xr[kRowVecs];
    if (live) {
      const uint4* xv = reinterpret_cast<const uint4*>(x + row * h);
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        const int i = t + k * row_threads;
        if (i < nvec) xr[k] = xv[i];
      }
    }

    float mean = 0.f;
    if constexpr (kCentred) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        if (live && t + k * row_threads < nvec) {
          const TX* e = reinterpret_cast<const TX*>(&xr[k]);
#pragma unroll
          for (int j = 0; j < V; ++j) s += to_float(e[j]);
        }
      }
      mean = row_sum(s, red[parity], warps, g) / hf;
      parity ^= 1;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      if (live && t + k * row_threads < nvec) {
        const TX* e = reinterpret_cast<const TX*>(&xr[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = centre<kCentred>(to_float(e[j]), mean);
          ss += c * c;
        }
      }
    }
    const float r = rsqrtf(row_sum(ss, red[parity], warps, g) / hf + eps);
    parity ^= 1;
    if (!live) continue;
    if (t == 0) {
      if constexpr (kCentred) mu[row] = mean;
      rstd[row] = r;
    }

    uint4* yv = reinterpret_cast<uint4*>(y + row * h);
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = t + k * row_threads;
      if (i < nvec) {
        const TX* e = reinterpret_cast<const TX*>(&xr[k]);
        uint4 out;
        TX* o = reinterpret_cast<TX*>(&out);
        float wv[V], bv[V];
        if (affine) {
          load_params<TW, V>(w + i * V, wv);
          if constexpr (kCentred) load_params<TW, V>(b + i * V, bv);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = centre<kCentred>(to_float(e[j]), mean) * r;
          if (affine) {
            v *= wv[j];
            if constexpr (kCentred) v += bv[j];
          }
          o[j] = from_float<TX>(v);
        }
        yv[i] = out;
      }
    }
  }
}

// mu is written only when kCentred; b may be null (no affine) either way.
template <bool kCentred, typename TX, typename TW, bool kVec>
__global__ void fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                           const TW* __restrict__ b, TX* __restrict__ y,
                           float* __restrict__ mu, float* __restrict__ rstd,
                           int h, float eps) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * h;
  TX* yr = y + row * h;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);

  float mean = 0.f;
  if constexpr (kCentred) {
    float s = 0.f;
    if (kVec) {
      for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
        uint4 raw = xv[i];
        const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) s += to_float(e[j]);
      }
    } else {
      for (int i = threadIdx.x; i < h; i += blockDim.x) s += to_float(xr[i]);
    }
    mean = block_sum(s) / static_cast<float>(h);
  }

  float ss = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = centre<kCentred>(to_float(e[j]), mean);
        ss += c * c;
      }
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float c = centre<kCentred>(to_float(xr[i]), mean);
      ss += c * c;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(h) + eps);
  if (threadIdx.x == 0) {
    if constexpr (kCentred) mu[row] = mean;
    rstd[row] = r;
  }

  if (kVec) {
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 out;
      TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_float<TX>(scale_shift<kCentred>(
            centre<kCentred>(to_float(e[j]), mean) * r, w, b, i * V + j));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      yr[i] = from_float<TX>(
          scale_shift<kCentred>(centre<kCentred>(to_float(xr[i]), mean) * r, w, b, i));
  }
}

template <bool kCentred, typename TX, typename TW>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       float* mu, float* rstd, int rows, int h, float eps,
                       const Plan& pl, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TW* bp = static_cast<const TW*>(b);
  TX* yp = static_cast<TX*>(y);
  if (pl.registers)
    fwd_rows_kernel<kCentred, TX, TW>
        <<<pl.blocks, pl.rows_per_block * pl.row_threads, 0, stream>>>(
            xp, wp, bp, yp, mu, rstd, rows, h, pl.row_threads, eps);
  else if (vec_ok<TX>(h, {x, y}))
    fwd_kernel<kCentred, TX, TW, true><<<rows, pl.row_threads, 0, stream>>>(xp, wp, bp, yp, mu, rstd, h, eps);
  else
    fwd_kernel<kCentred, TX, TW, false><<<rows, pl.row_threads, 0, stream>>>(xp, wp, bp, yp, mu, rstd, h, eps);
  return cudaGetLastError();
}

// the loop path takes a block a row, of 32 to 1024 threads
template <typename TX>
bool fwd_plan_ok(const Plan& pl, int rows, int h, const void* x,
                 const void* y, const void* w, const void* b) {
  if (!pl.registers)
    return pl.rows_per_block == 1 && pl.blocks == rows &&
           pl.row_threads % 32 == 0 && pl.row_threads >= 32 &&
           pl.row_threads <= kMaxThreads;
  return rows_plan_ok<TX>(pl, rows, h,
                          {x, y, w == nullptr ? x : w, b == nullptr ? x : b});
}

template <bool kCentred, typename TX>
cudaError_t fwd_w(const void* x, const void* w, const void* b, int w_dtype,
                  void* y, float* mu, float* rstd, int rows, int h, float eps,
                  const Plan& pl, cudaStream_t stream) {
  if (!fwd_plan_ok<TX>(pl, rows, h, x, y, w, b)) return cudaErrorInvalidValue;
  switch (w_dtype) {
    case kFloat32: return launch_fwd<kCentred, TX, float>(x, w, b, y, mu, rstd, rows, h, eps, pl, stream);
    case kBFloat16: return launch_fwd<kCentred, TX, __nv_bfloat16>(x, w, b, y, mu, rstd, rows, h, eps, pl, stream);
    case kFloat16: return launch_fwd<kCentred, TX, __half>(x, w, b, y, mu, rstd, rows, h, eps, pl, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x, y [rows, h] contiguous in x_dtype; w (and b) [h] in w_dtype or null
// (no affine; w_dtype is then ignored); mu (when kCentred), rstd [rows]
// fp32; the plan as Plan says, checked against the shape and the pointers
// (cudaErrorInvalidValue if it does not fit).
template <bool kCentred>
int fwd(const void* x, const void* w, const void* b, void* y, void* mu,
        void* rstd, int rows, int h, float eps, int row_threads,
        int rows_per_block, int blocks, int registers, int x_dtype,
        int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (w == nullptr) w_dtype = x_dtype;
  const Plan pl{row_threads, rows_per_block, blocks, registers};
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return fwd_w<kCentred, float>(x, w, b, w_dtype, y, m, r, rows, h, eps, pl, s);
    case kBFloat16: return fwd_w<kCentred, __nv_bfloat16>(x, w, b, w_dtype, y, m, r, rows, h, eps, pl, s);
    case kFloat16: return fwd_w<kCentred, __half>(x, w, b, w_dtype, y, m, r, rows, h, eps, pl, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ backward


// dst[0, V) = prior[0, V) + v, or v when prior is null, in float4s; dst
// and prior 16-byte aligned
template <int V>
__device__ __forceinline__ void join_sums(float* dst, const float* prior,
                                          const float (&v)[V]) {
  static_assert(V % 4 == 0, "a 16-byte vector holds 4 or 8 elements");
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    float4 a = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    if (prior != nullptr) {
      const float4 p = *reinterpret_cast<const float4*>(prior + j);
      a = make_float4(p.x + a.x, p.y + a.y, p.z + a.z, p.w + a.w);
    }
    *reinterpret_cast<float4*>(dst + j) = a;
  }
}

// The row-register path. blockDim.x = rows_per_block * row_threads, row
// slot g = threadIdx.x / row_threads; thread t of a row owns the vectors
// t + k * row_threads, k < kRowVecs, that lie below h / V. part is
// [gridDim.x, kAcc * h] fp32 (dw, then db when kCentred) or null (no
// affine weight); mu is read only when kCentred.
template <bool kCentred, typename TX, typename TW>
__global__ void __launch_bounds__(kMaxRowThreads)
    bwd_rows_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                    const float* __restrict__ mu,
                    const float* __restrict__ rstd, const TW* __restrict__ w,
                    TX* __restrict__ dx, float* __restrict__ part, int rows,
                    int h, int row_threads) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  constexpr int kAcc = kCentred ? 2 : 1;
  // per warp and row-loop parity: the warp's (s1, s2)
  __shared__ float red[2][kMaxRowThreads / 32][2];
  extern __shared__ float acc[];  // [kAcc * h]: the slots' joined sums
  const bool affine = part != nullptr;
  const int slots = blockDim.x / row_threads;
  const int g = threadIdx.x / row_threads;
  const int t = threadIdx.x - g * row_threads;
  const int warps = row_threads >> 5;  // warps of one row
  const int nvec = h / V;
  const float inv_h = 1.f / static_cast<float>(h);

  float dw_acc[kRowVecs][V], db_acc[kRowVecs][V];
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) dw_acc[k][j] = db_acc[k][j] = 0.f;

  int parity = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * slots;
  // the bound is on the block's first row, so every thread of the block
  // runs the same iterations and reaches the same barriers
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * slots; base < rows;
       base += step) {
    const int64_t row = base + g;
    const bool live = row < rows;
    uint4 xr[kRowVecs], gr[kRowVecs];
    float m = 0.f, r = 0.f;
    if (live) {
      const uint4* xv = reinterpret_cast<const uint4*>(x + row * h);
      const uint4* gv = reinterpret_cast<const uint4*>(dy + row * h);
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        const int i = t + k * row_threads;
        if (i < nvec) {
          xr[k] = xv[i];
          gr[k] = gv[i];
        }
      }
      if constexpr (kCentred) m = mu[row];
      r = rstd[row];
    }

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = t + k * row_threads;
      if (live && i < nvec) {
        const TX* xe = reinterpret_cast<const TX*>(&xr[k]);
        const TX* ge = reinterpret_cast<const TX*>(&gr[k]);
        float wv[V];
        if (w != nullptr) {
          load_params<TW, V>(w + i * V, wv);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) wv[j] = 1.f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gw = to_float(ge[j]) * wv[j];
          if constexpr (kCentred) s1 += gw;
          s2 += gw * (centre<kCentred>(to_float(xe[j]), m) * r);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if constexpr (kCentred) s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (warps > 1) {  // uniform: one shared-memory step joins the warps
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        red[parity][warp][0] = s1;
        red[parity][warp][1] = s2;
      }
      __syncthreads();
      s1 = s2 = 0.f;
      for (int k = 0; k < warps; ++k) {
        s1 += red[parity][g * warps + k][0];
        s2 += red[parity][g * warps + k][1];
      }
      // the next iteration writes the other half; the one after it finds
      // this half read, since every thread passed the next barrier
      parity ^= 1;
    }
    const float m1 = s1 * inv_h, m2 = s2 * inv_h;
    if (!live) continue;

    uint4* dv = reinterpret_cast<uint4*>(dx + row * h);
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = t + k * row_threads;
      if (i < nvec) {
        const TX* xe = reinterpret_cast<const TX*>(&xr[k]);
        const TX* ge = reinterpret_cast<const TX*>(&gr[k]);
        float wv[V];
        if (w != nullptr) {
          load_params<TW, V>(w + i * V, wv);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) wv[j] = 1.f;
        }
        uint4 out;
        TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = centre<kCentred>(to_float(xe[j]), m) * r;
          const float gv = to_float(ge[j]);
          o[j] = from_float<TX>(r * (centre<kCentred>(gv * wv[j], m1) - xh * m2));
          dw_acc[k][j] += gv * xh;
          if constexpr (kCentred) db_acc[k][j] += gv;
        }
        dv[i] = out;
      }
    }
  }
  if (!affine) return;

  // join the row slots' sums in slot order: slots 0 .. slots-2 through
  // shared memory, the last one straight into this block's partial row
  float* out = part + static_cast<int64_t>(blockIdx.x) * kAcc * h;
  for (int s = 0; s < slots; ++s) {
    if (g == s) {
      float* dst = s + 1 < slots ? acc : out;
      const float* prior = s > 0 ? acc : nullptr;
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        const int i = t + k * row_threads;
        if (i < nvec) {
          const int c = i * V;
          join_sums<V>(dst + c, prior ? prior + c : nullptr, dw_acc[k]);
          if constexpr (kCentred)
            join_sums<V>(dst + h + c, prior ? prior + h + c : nullptr,
                         db_acc[k]);
        }
      }
    }
    if (s + 1 < slots) __syncthreads();
  }
}

// The loop path: one block per `blocks`-th row (gridDim.x = blocks). part
// is [blocks, kAcc*h] fp32 (the dw sums, then with kCentred the db sums),
// or null when there is no affine weight; mu is read only when kCentred.
template <bool kCentred, typename TX, typename TW, bool kVec>
__global__ void bwd_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           const TW* __restrict__ w, TX* __restrict__ dx,
                           float* __restrict__ part, int rows, int h) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  constexpr int kAcc = kCentred ? 2 : 1;
  extern __shared__ float acc[];      // [kAcc * h] when part is not null
  const bool affine = part != nullptr;
  // zeroed before the first row's block_sum, whose barriers order these
  // stores before every thread's first accumulation
  if (affine)
    for (int i = threadIdx.x; i < kAcc * h; i += blockDim.x) acc[i] = 0.f;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * h;
    const TX* gr = dy + row * h;
    TX* dxr = dx + row * h;
    float m = 0.f;
    if constexpr (kCentred) m = mu[row];
    const float r = rstd[row];

    float s1 = 0.f, s2 = 0.f;
    if (kVec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const uint4* gv = reinterpret_cast<const uint4*>(gr);
      for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
        uint4 xraw = xv[i], graw = gv[i];
        const TX* xe = reinterpret_cast<const TX*>(&xraw);
        const TX* ge = reinterpret_cast<const TX*>(&graw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gw = to_float(ge[j]) * param_at(w, i * V + j, 1.f);
          if constexpr (kCentred) s1 += gw;
          s2 += gw * (centre<kCentred>(to_float(xe[j]), m) * r);
        }
      }
    } else {
      for (int i = threadIdx.x; i < h; i += blockDim.x) {
        const float gw = to_float(gr[i]) * param_at(w, i, 1.f);
        if constexpr (kCentred) s1 += gw;
        s2 += gw * (centre<kCentred>(to_float(xr[i]), m) * r);
      }
    }
    float m1 = 0.f;
    if constexpr (kCentred) m1 = block_sum(s1) / static_cast<float>(h);
    const float m2 = block_sum(s2) / static_cast<float>(h);

    if (kVec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const uint4* gv = reinterpret_cast<const uint4*>(gr);
      uint4* dv = reinterpret_cast<uint4*>(dxr);
      for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
        uint4 xraw = xv[i], graw = gv[i];
        const TX* xe = reinterpret_cast<const TX*>(&xraw);
        const TX* ge = reinterpret_cast<const TX*>(&graw);
        uint4 out;
        TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = i * V + j;
          const float xh = centre<kCentred>(to_float(xe[j]), m) * r;
          const float g = to_float(ge[j]);
          o[j] = from_float<TX>(r * (centre<kCentred>(g * param_at(w, c, 1.f), m1) - xh * m2));
          if (affine) {
            acc[c] += g * xh;
            if constexpr (kCentred) acc[h + c] += g;
          }
        }
        dv[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < h; i += blockDim.x) {
        const float xh = centre<kCentred>(to_float(xr[i]), m) * r;
        const float g = to_float(gr[i]);
        dxr[i] = from_float<TX>(r * (centre<kCentred>(g * param_at(w, i, 1.f), m1) - xh * m2));
        if (affine) {
          acc[i] += g * xh;
          if constexpr (kCentred) acc[h + i] += g;
        }
      }
    }
  }
  if (affine) {
    __syncthreads();
    for (int i = threadIdx.x; i < kAcc * h; i += blockDim.x)
      part[static_cast<int64_t>(blockIdx.x) * kAcc * h + i] = acc[i];
  }
}

// out[c] = sum over the parts rows of part[:, c] for c < cols = kAcc * h:
// column c < h goes to dw[c], the rest to db[c - h]. A block of (32,
// kSumSlices) threads takes 32 columns; slice y adds rows y, y +
// kSumSlices, ... in order, then thread y = 0 adds the slices in order.
template <typename TW>
__global__ void __launch_bounds__(32 * kSumSlices)
    column_sum_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                      TW* __restrict__ db, int parts, int h, int cols) {
  __shared__ float slice[kSumSlices][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += kSumSlices)
      s += part[static_cast<int64_t>(p) * cols + c];
  }
  slice[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= cols) return;
  s = 0.f;
#pragma unroll
  for (int y = 0; y < kSumSlices; ++y) s += slice[y][threadIdx.x];
  if (c < h)
    dw[c] = from_float<TW>(s);
  else
    db[c - h] = from_float<TW>(s);
}

template <typename TX>
bool bwd_plan_ok(const Plan& pl, int rows, int h, const void* x,
                 const void* dy, const void* dx, const void* w) {
  if (pl.blocks < 1 || pl.blocks > rows || pl.rows_per_block < 1) return false;
  if (!pl.registers)
    return pl.rows_per_block == 1 && pl.row_threads % 32 == 0 &&
           pl.row_threads >= 32 && pl.row_threads <= kMaxThreads;
  return rows_plan_ok<TX>(pl, rows, h, {x, dy, dx, w == nullptr ? x : w});
}

template <bool kCentred, typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mu,
                       const float* rstd, const void* w, void* dx, void* dw,
                       void* db, float* part, int rows, int h,
                       const Plan& pl, cudaStream_t stream) {
  constexpr int kAcc = kCentred ? 2 : 1;
  const bool affine = w != nullptr;
  const size_t acc_bytes = kAcc * static_cast<size_t>(h) * sizeof(float);
  const TX* xp = static_cast<const TX*>(x);
  const TX* gp = static_cast<const TX*>(dy);
  const TW* wp = static_cast<const TW*>(w);
  TX* dxp = static_cast<TX*>(dx);
  float* pp = affine ? part : nullptr;
  cudaError_t err;
  if (pl.registers) {
    // shared memory only to join several row slots' column sums (at most
    // 2 x 4096 floats: several slots means row_threads <= 128)
    const size_t smem = affine && pl.rows_per_block > 1 ? acc_bytes : 0;
    bwd_rows_kernel<kCentred, TX, TW>
        <<<pl.blocks, pl.rows_per_block * pl.row_threads, smem, stream>>>(
            xp, gp, mu, rstd, wp, dxp, pp, rows, h, pl.row_threads);
  } else {
    const size_t smem = affine ? acc_bytes : 0;
    if (vec_ok<TX>(h, {x, dy, dx})) {
      err = cudaFuncSetAttribute(bwd_kernel<kCentred, TX, TW, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      bwd_kernel<kCentred, TX, TW, true><<<pl.blocks, pl.row_threads, smem, stream>>>(
          xp, gp, mu, rstd, wp, dxp, pp, rows, h);
    } else {
      err = cudaFuncSetAttribute(bwd_kernel<kCentred, TX, TW, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      bwd_kernel<kCentred, TX, TW, false><<<pl.blocks, pl.row_threads, smem, stream>>>(
          xp, gp, mu, rstd, wp, dxp, pp, rows, h);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !affine) return err;
  column_sum_kernel<TW><<<(kAcc * h + 31) / 32, dim3(32, kSumSlices), 0, stream>>>(
      part, static_cast<TW*>(dw), static_cast<TW*>(db), pl.blocks, h, kAcc * h);
  return cudaGetLastError();
}

template <bool kCentred, typename TX>
cudaError_t bwd_w(const void* x, const void* dy, const float* mu,
                  const float* rstd, const void* w, int w_dtype, void* dx,
                  void* dw, void* db, float* part, int rows, int h,
                  const Plan& pl, cudaStream_t stream) {
  if (!bwd_plan_ok<TX>(pl, rows, h, x, dy, dx, w))
    return cudaErrorInvalidValue;
  switch (w_dtype) {
    case kFloat32: return launch_bwd<kCentred, TX, float>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, pl, stream);
    case kBFloat16: return launch_bwd<kCentred, TX, __nv_bfloat16>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, pl, stream);
    case kFloat16: return launch_bwd<kCentred, TX, __half>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, pl, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x, dy, dx [rows, h] contiguous in x_dtype; mu (when kCentred), rstd
// [rows] fp32; w [h] in w_dtype or null (no affine: dw, db and part are
// then ignored); dw (and db when kCentred) [h] in w_dtype; part
// [blocks, kAcc * h] fp32 scratch; the plan as Plan says, checked
// against the shape and the pointers (cudaErrorInvalidValue if it does
// not fit).
template <bool kCentred>
int bwd(const void* x, const void* dy, const void* mu, const void* rstd,
        const void* w, void* dx, void* dw, void* db, void* part, int rows,
        int h, int row_threads, int rows_per_block, int blocks, int registers,
        int x_dtype, int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (w == nullptr) w_dtype = x_dtype;
  const Plan pl{row_threads, rows_per_block, blocks, registers};
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return bwd_w<kCentred, float>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, pl, s);
    case kBFloat16: return bwd_w<kCentred, __nv_bfloat16>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, pl, s);
    case kFloat16: return bwd_w<kCentred, __half>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, pl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace row_norm
