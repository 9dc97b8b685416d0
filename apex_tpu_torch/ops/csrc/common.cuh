// Shared helpers of the port's CUDA kernels: dtype conversion, block-wide
// reductions and the error-string entry every library exports for its
// ctypes wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes, kept in step with apex_tpu_torch/ops/_build.py DTYPE_CODES
enum DtypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Sum (block_sum) or maximum (block_max) of v over the block, returned to
// every thread: a warp-shuffle step, then one shared-memory step across
// the warps. blockDim.x is a multiple of 32, at most 1024. Two calls in a
// row are safe: a thread reads the result of the first before it reaches
// the barrier that lets the second overwrite it.
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

__device__ __forceinline__ float block_max(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float s = partial[lane < nwarps ? lane : 0];
    for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
