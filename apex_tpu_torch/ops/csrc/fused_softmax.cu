// Whole-row scaled, masked softmax for Hopper (sm_90a): the causal and the
// padding-masked variant of one kernel.
//
// fused_softmax_causal replaces
// apex_tpu/transformer/functional/fused_softmax.py:104 _causal_kernel
// (launched by _pallas_causal, :128); fused_softmax_masked replaces :119
// _masked_kernel (launched by _pallas_masked, :254). Per row of x, whose
// last two dims are [sq, sk], in fp32:
//   s = x * scale
//   s = -10000 where masked        causal: col > row + (sk - sq);
//                                  masked: mask[..., row, col] != 0
//   y = exp(s - max(s)) / sum(exp(s - max(s)))      stored in x's dtype
// The fill is -10000, not -inf, exactly as the reference: a masked element
// keeps its exp(-10000 - max), and a fully masked row comes out uniform.
// Rows up to sk = 16384 (the reference's _WHOLE_ROW_MAX_SK); longer rows
// belong to the blocked two-pass kernels, which are not ported.
//
// Bound: bytes. y is written whole, but x is needed only where unmasked:
// a masked element's output is exp(-10000 - max) / sum whatever x holds.
// For GPT-2's causal [128, 1024, 1024] bf16 that is 134 MB of reads and
// 268 MB of writes, 0.120 ms at 3.35 TB/s; about six flops an element.
// This kernel reads every element of x, masked or not.
//
// Design: one block per row, the whole row held in registers: a thread
// keeps at most 16 fp32 values (sk <= 16384 over at most 1024 threads), so
// x leaves device memory once and y is written once. 16-byte vector loads
// and stores when sk and the pointers allow them, a scalar path otherwise.
// The row max and the sum of exponentials are block reductions. The mask
// is read through four element strides (zero on broadcast dims), so a
// [b, 1, 1, sk] padding mask is never expanded to x's shape; the causal
// mask is computed from the row and column indices.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxValues = 16;  // fp32 values a thread holds
constexpr int kMaxSk = kMaxThreads * kMaxValues;
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

// V elements per load (16 bytes, or 1 on the scalar path); a thread holds
// the vectors threadIdx.x + k * blockDim.x for k < kMaxValues / V.
template <typename T, int V, bool kCausal>
__global__ void __launch_bounds__(kMaxThreads)
    softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                        MaskView mask, int sq, int sk, float scale) {
  constexpr int NV = kMaxValues / V;
  const int64_t row = blockIdx.x;
  const int q = static_cast<int>(row % sq);
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const uint8_t* mr = nullptr;
  if (!kCausal) {
    const int64_t lead = row / sq;
    mr = mask.ptr + (lead / mask.d1) * mask.s0 + (lead % mask.d1) * mask.s1 +
         static_cast<int64_t>(q) * mask.s2;
  }
  const int nvec = sk / V;

  float v[NV][V];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load<T, V>(xr + static_cast<int64_t>(i) * V, v[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = i * V + j;
        const bool masked =
            kCausal ? c > q + (sk - sq) : mr[c * mask.s3] != 0;
        v[k][j] = masked ? kMaskFill : v[k][j] * scale;
        mx = fmaxf(mx, v[k][j]);
      }
    }
  }
  mx = block_max(mx);

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (threadIdx.x + k * blockDim.x < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[k][j] = expf(v[k][j] - mx);
        sum += v[k][j];
      }
    }
  }
  sum = block_sum(sum);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = v[k][j] / sum;
      store<T, V>(yr + static_cast<int64_t>(i) * V, v[k]);
    }
  }
}

template <typename T, bool kCausal>
cudaError_t launch(const void* x, void* y, MaskView mask, int64_t rows,
                   int sq, int sk, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = sk % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int work = vec ? sk / V : sk;
  int threads = ((work + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vec)
    softmax_rows_kernel<T, V, kCausal><<<rows, threads, 0, stream>>>(xp, yp, mask, sq, sk, scale);
  else
    softmax_rows_kernel<T, 1, kCausal><<<rows, threads, 0, stream>>>(xp, yp, mask, sq, sk, scale);
  return cudaGetLastError();
}

template <bool kCausal>
int dispatch(const void* x, void* y, MaskView mask, long long rows, int sq,
             int sk, float scale, int dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (sq < 1 || sk < 1 || sk > kMaxSk || rows % sq != 0 ||
      rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float, kCausal>(x, y, mask, rows, sq, sk, scale, s);
    case kBFloat16: return launch<__nv_bfloat16, kCausal>(x, y, mask, rows, sq, sk, scale, s);
    case kFloat16: return launch<__half, kCausal>(x, y, mask, rows, sq, sk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y contiguous, rows = (product of the leading dims) * sq rows of sk
// elements in dtype; 1 <= sk <= 16384.
extern "C" int fused_softmax_causal(const void* x, void* y, long long rows,
                                    int sq, int sk, float scale, int dtype,
                                    void* stream) {
  return dispatch<true>(x, y, MaskView{nullptr, 1, 0, 0, 0, 0}, rows, sq, sk,
                        scale, dtype, stream);
}

// As fused_softmax_causal, with a one-byte boolean mask (nonzero = masked)
// read at mask + i0*s0 + i1*s1 + q*s2 + c*s3 for x viewed as
// [rows / (d1 * sq), d1, sq, sk].
extern "C" int fused_softmax_masked(const void* x, const void* mask, void* y,
                                    long long rows, int sq, int sk,
                                    long long d1, long long s0, long long s1,
                                    long long s2, long long s3, float scale,
                                    int dtype, void* stream) {
  if (mask == nullptr || d1 < 1) return cudaErrorInvalidValue;
  return dispatch<false>(
      x, y, MaskView{static_cast<const uint8_t*>(mask), d1, s0, s1, s2, s3},
      rows, sq, sk, scale, dtype, stream);
}
