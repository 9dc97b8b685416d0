// RMSNorm forward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/layer_norm.py:56 _rms_fwd_kernel (launched by
// _rms_fwd_pallas, :127). Per row of x [rows, h]:
//   rstd = rsqrt(mean(x^2) + eps)        fp32
//   y    = (x * rstd) * w                fp32 math, stored in x's dtype
// and rstd [rows] is written in fp32, as the TPU kernel saves it.
//
// Bound: bytes. It reads x and w and writes y (and 4 bytes of rstd per
// row), with about 4 flops per element, far below Hopper's ~295 flop/byte
// ridge. Design: one block per row, so a row's sum of squares never
// leaves the SM; 16-byte vector loads and stores when h and the row
// pointers allow them (a scalar path otherwise, so any h works); an fp32
// warp-shuffle reduction, then one shared-memory step across warps. The
// second pass re-reads the row, which is still in L1/L2, so device memory
// sees x once. The TPU's row blocks of (8, 128) tiles are not carried
// over: a row of h = 4096 fills one block of 512 threads.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float s = lane < nwarps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

template <typename TW>
__device__ __forceinline__ float weight_at(const TW* w, int i) {
  return w == nullptr ? 1.f : to_float(w[i]);
}

template <typename TX, typename TW, bool kVec>
__global__ void rms_fwd_kernel(const TX* __restrict__ x,
                               const TW* __restrict__ w,
                               TX* __restrict__ y, float* __restrict__ rstd,
                               int h, float eps) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * h;
  TX* yr = y + row * h;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_float(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float f = to_float(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(h) + eps);
  if (threadIdx.x == 0) rstd[row] = r;

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 out;
      TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_float<TX>(to_float(e[j]) * r * weight_at(w, i * V + j));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      yr[i] = from_float<TX>(to_float(xr[i]) * r * weight_at(w, i));
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, float* rstd,
                   int rows, int h, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const bool vec = h % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int work = vec ? h / V : h;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (vec)
    rms_fwd_kernel<TX, TW, true><<<rows, threads, 0, stream>>>(xp, wp, yp, rstd, h, eps);
  else
    rms_fwd_kernel<TX, TW, false><<<rows, threads, 0, stream>>>(xp, wp, yp, rstd, h, eps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_w(const void* x, const void* w, int w_dtype, void* y,
                       float* rstd, int rows, int h, float eps,
                       cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch<TX, float>(x, w, y, rstd, rows, h, eps, stream);
    case kBFloat16: return launch<TX, __nv_bfloat16>(x, w, y, rstd, rows, h, eps, stream);
    case kFloat16: return launch<TX, __half>(x, w, y, rstd, rows, h, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [rows, h] contiguous in dtype x_dtype; w [h] in w_dtype or null
// (no affine; w_dtype is then ignored); rstd [rows] fp32.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* rstd, int rows, int h, float eps,
                            int x_dtype, int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (w == nullptr) w_dtype = x_dtype;
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return dispatch_w<float>(x, w, w_dtype, y, r, rows, h, eps, s);
    case kBFloat16: return dispatch_w<__nv_bfloat16>(x, w, w_dtype, y, r, rows, h, eps, s);
    case kFloat16: return dispatch_w<__half>(x, w, w_dtype, y, r, rows, h, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
