// RMSNorm forward and backward for Hopper (sm_90a).
//
// rms_norm_fwd replaces apex_tpu/ops/layer_norm.py:56 _rms_fwd_kernel
// (launched by _rms_fwd_pallas, :127). Per row of x [rows, h]:
//   rstd = rsqrt(mean(x^2) + eps)        fp32
//   y    = (x * rstd) * w                fp32 math, stored in x's dtype
// and rstd [rows] is written in fp32, as the TPU kernel saves it.
//
// rms_norm_bwd replaces apex_tpu/ops/layer_norm.py:189 _rms_bwd_kernel
// (launched by _rms_bwd_pallas, :282). With xhat = x * rstd, gw = dy * w:
//   dx = rstd * (gw - xhat * mean(gw * xhat))   per row, in x's dtype
//   dw = sum over rows of dy * xhat              fp32, stored in w's dtype
//
// Bound: bytes, both ways. The forward reads x and w and writes y (and 4
// bytes of rstd per row); the backward reads x, dy, rstd and w and writes
// dx and dw (100.7 MB, 0.030 ms at 3.35 TB/s, for 4096 x 4096 bf16). Each
// does a few flops per element, far below Hopper's ~295 flop/byte ridge.
//
// Design: one block per row for the forward, so a row's sum of squares
// never leaves the SM; 16-byte vector loads and stores when h and the row
// pointers allow them (a scalar path otherwise, so any h works); an fp32
// warp-shuffle reduction, then one shared-memory step across warps. The
// second pass re-reads the row, which is still in L1/L2, so device memory
// sees x once. The TPU's row blocks of (8, 128) tiles are not carried
// over: a row of h = 4096 fills one block of 512 threads.
//
// The backward keeps that shape for dx. Its dw is a sum across all rows,
// which the TPU kernel carries in one (1, h) block from grid step to grid
// step; Hopper's blocks run in no order and share nothing, so dw takes two
// passes instead of atomics (whose order, and so whose rounding, would
// change from run to run): a fixed number of blocks (`parts`, chosen by
// the wrapper) each walk every parts-th row and keep their fp32 column
// sums of dy * xhat in shared memory (h floats; each thread owns the
// same columns on every row, so no synchronisation is needed), write them
// as one row of a [parts, h] fp32 buffer, and a second kernel sums that
// buffer down its columns in a fixed order and stores dw.

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

// One block per `parts`-th row (gridDim.x = parts). dw_part is
// [parts, h] fp32, or null when there is no affine weight.
template <typename TX, typename TW, bool kVec>
__global__ void rms_bwd_kernel(const TX* __restrict__ x,
                               const TX* __restrict__ dy,
                               const float* __restrict__ rstd,
                               const TW* __restrict__ w,
                               TX* __restrict__ dx,
                               float* __restrict__ dw_part, int rows, int h) {
  constexpr int V = 16 / sizeof(TX);  // elements per 16-byte vector
  extern __shared__ float dw_acc[];   // [h] when dw_part is not null
  const bool affine = dw_part != nullptr;
  if (affine)
    for (int i = threadIdx.x; i < h; i += blockDim.x) dw_acc[i] = 0.f;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * h;
    const TX* gr = dy + row * h;
    TX* dxr = dx + row * h;
    const float r = rstd[row];

    float s = 0.f;
    if (kVec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const uint4* gv = reinterpret_cast<const uint4*>(gr);
      for (int i = threadIdx.x; i < h / V; i += blockDim.x) {
        uint4 xraw = xv[i], graw = gv[i];
        const TX* xe = reinterpret_cast<const TX*>(&xraw);
        const TX* ge = reinterpret_cast<const TX*>(&graw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          s += to_float(ge[j]) * weight_at(w, i * V + j) * (to_float(xe[j]) * r);
      }
    } else {
      for (int i = threadIdx.x; i < h; i += blockDim.x)
        s += to_float(gr[i]) * weight_at(w, i) * (to_float(xr[i]) * r);
    }
    const float m2 = block_sum(s) / static_cast<float>(h);

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
          const float xh = to_float(xe[j]) * r;
          const float g = to_float(ge[j]);
          o[j] = from_float<TX>(r * (g * weight_at(w, i * V + j) - xh * m2));
          if (affine) dw_acc[i * V + j] += g * xh;
        }
        dv[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < h; i += blockDim.x) {
        const float xh = to_float(xr[i]) * r;
        const float g = to_float(gr[i]);
        dxr[i] = from_float<TX>(r * (g * weight_at(w, i) - xh * m2));
        if (affine) dw_acc[i] += g * xh;
      }
    }
  }
  if (affine) {
    __syncthreads();
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      dw_part[static_cast<int64_t>(blockIdx.x) * h + i] = dw_acc[i];
  }
}

// dw[c] = sum over the parts rows of dw_part[:, c], in row order.
template <typename TW>
__global__ void rms_dw_reduce_kernel(const float* __restrict__ dw_part,
                                     TW* __restrict__ dw, int parts, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += dw_part[static_cast<int64_t>(b) * h + c];
  dw[c] = from_float<TW>(s);
}

template <typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* dy, const float* rstd,
                       const void* w, void* dx, void* dw, float* dw_part,
                       int rows, int h, int parts, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const bool vec = h % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int work = vec ? h / V : h;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const bool affine = w != nullptr;
  const size_t smem = affine ? static_cast<size_t>(h) * sizeof(float) : 0;
  const TX* xp = static_cast<const TX*>(x);
  const TX* gp = static_cast<const TX*>(dy);
  const TW* wp = static_cast<const TW*>(w);
  TX* dxp = static_cast<TX*>(dx);
  float* part = affine ? dw_part : nullptr;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(rms_bwd_kernel<TX, TW, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rms_bwd_kernel<TX, TW, true><<<parts, threads, smem, stream>>>(
        xp, gp, rstd, wp, dxp, part, rows, h);
  } else {
    err = cudaFuncSetAttribute(rms_bwd_kernel<TX, TW, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rms_bwd_kernel<TX, TW, false><<<parts, threads, smem, stream>>>(
        xp, gp, rstd, wp, dxp, part, rows, h);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !affine) return err;
  rms_dw_reduce_kernel<TW><<<(h + 255) / 256, 256, 0, stream>>>(
      dw_part, static_cast<TW*>(dw), parts, h);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_bwd_w(const void* x, const void* dy, const float* rstd,
                           const void* w, int w_dtype, void* dx, void* dw,
                           float* dw_part, int rows, int h, int parts,
                           cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch_bwd<TX, float>(x, dy, rstd, w, dx, dw, dw_part, rows, h, parts, stream);
    case kBFloat16: return launch_bwd<TX, __nv_bfloat16>(x, dy, rstd, w, dx, dw, dw_part, rows, h, parts, stream);
    case kFloat16: return launch_bwd<TX, __half>(x, dy, rstd, w, dx, dw, dw_part, rows, h, parts, stream);
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

// x, dy, dx [rows, h] contiguous in dtype x_dtype; rstd [rows] fp32; w [h]
// in w_dtype or null (no affine: dw and dw_part are then ignored); dw [h]
// in w_dtype; dw_part [parts, h] fp32 scratch; 1 <= parts <= rows.
extern "C" int rms_norm_bwd(const void* x, const void* dy, const void* rstd,
                            const void* w, void* dx, void* dw, void* dw_part,
                            int rows, int h, int parts, int x_dtype,
                            int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (parts < 1 || parts > rows) return cudaErrorInvalidValue;
  if (w == nullptr) w_dtype = x_dtype;
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(dw_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return dispatch_bwd_w<float>(x, dy, r, w, w_dtype, dx, dw, part, rows, h, parts, s);
    case kBFloat16: return dispatch_bwd_w<__nv_bfloat16>(x, dy, r, w, w_dtype, dx, dw, part, rows, h, parts, s);
    case kFloat16: return dispatch_bwd_w<__half>(x, dy, r, w, w_dtype, dx, dw, part, rows, h, parts, s);
    default: return cudaErrorInvalidValue;
  }
}
