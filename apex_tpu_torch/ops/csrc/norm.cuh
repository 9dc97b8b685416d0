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
// Design: one block per row for the forward, so a row's sums never leave
// the SM; 16-byte vector loads and stores when h and the row pointers
// allow them (a scalar path otherwise, so any h and any row count work:
// there is no padding to a row block, as the TPU's _pad_rows needs); fp32
// warp-shuffle reductions, then one shared-memory step across warps. The
// later passes over a row (LayerNorm's centred squares, the output) find
// it in L1/L2, so device memory sees x once. The TPU's (8, 128) row tiles
// are not carried over: a row of h = 4096 fills one block of 512 threads.
//
// The backward keeps that shape for dx. Its dw (and db) are sums across
// all rows, which the TPU kernels carry in (1, h) blocks from grid step to
// grid step; Hopper's blocks run in no order and share nothing, so they
// take two passes instead of atomics (whose order, and so whose rounding,
// would change from run to run): a fixed number of blocks (`parts`, chosen
// by the wrapper) each walk every parts-th row and keep fp32 column sums
// in shared memory (h floats, 2h with db; each thread owns the same
// columns on every row, so no synchronisation is needed), write them as
// one row of a [parts, h] or [parts, 2h] fp32 buffer, and a second kernel
// sums that buffer down its columns in a fixed order. The result is the
// same on every run and on every card.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace row_norm {

constexpr int kMaxThreads = 1024;

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

inline int threads_for(int work) {
  int threads = ((work + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
}

template <typename TX>
bool vec_ok(int h, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(TX);
  if (h % V != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
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
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const bool vec = vec_ok<TX>(h, {x, y});
  const int threads = threads_for(vec ? h / V : h);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TW* bp = static_cast<const TW*>(b);
  TX* yp = static_cast<TX*>(y);
  if (vec)
    fwd_kernel<kCentred, TX, TW, true><<<rows, threads, 0, stream>>>(xp, wp, bp, yp, mu, rstd, h, eps);
  else
    fwd_kernel<kCentred, TX, TW, false><<<rows, threads, 0, stream>>>(xp, wp, bp, yp, mu, rstd, h, eps);
  return cudaGetLastError();
}

template <bool kCentred, typename TX>
cudaError_t fwd_w(const void* x, const void* w, const void* b, int w_dtype,
                  void* y, float* mu, float* rstd, int rows, int h, float eps,
                  cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch_fwd<kCentred, TX, float>(x, w, b, y, mu, rstd, rows, h, eps, stream);
    case kBFloat16: return launch_fwd<kCentred, TX, __nv_bfloat16>(x, w, b, y, mu, rstd, rows, h, eps, stream);
    case kFloat16: return launch_fwd<kCentred, TX, __half>(x, w, b, y, mu, rstd, rows, h, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x, y [rows, h] contiguous in x_dtype; w (and b) [h] in w_dtype or null
// (no affine; w_dtype is then ignored); mu (when kCentred), rstd [rows] fp32.
template <bool kCentred>
int fwd(const void* x, const void* w, const void* b, void* y, void* mu,
        void* rstd, int rows, int h, float eps, int x_dtype, int w_dtype,
        void* stream) {
  if (rows == 0) return cudaSuccess;
  if (w == nullptr) w_dtype = x_dtype;
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return fwd_w<kCentred, float>(x, w, b, w_dtype, y, m, r, rows, h, eps, s);
    case kBFloat16: return fwd_w<kCentred, __nv_bfloat16>(x, w, b, w_dtype, y, m, r, rows, h, eps, s);
    case kFloat16: return fwd_w<kCentred, __half>(x, w, b, w_dtype, y, m, r, rows, h, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// One block per `parts`-th row (gridDim.x = parts). part is [parts, kAcc*h]
// fp32 (the dw sums, then with kCentred the db sums), or null when there is
// no affine weight; mu is read only when kCentred.
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

// out[c] = sum over the parts rows of part[:, c] for c < cols = kAcc * h,
// in row order: column c < h goes to dw[c], the rest to db[c - h].
template <typename TW>
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  TW* __restrict__ dw, TW* __restrict__ db,
                                  int parts, int h, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<int64_t>(p) * cols + c];
  if (c < h)
    dw[c] = from_float<TW>(s);
  else
    db[c - h] = from_float<TW>(s);
}

template <bool kCentred, typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mu,
                       const float* rstd, const void* w, void* dx, void* dw,
                       void* db, float* part, int rows, int h, int parts,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int kAcc = kCentred ? 2 : 1;
  const bool vec = vec_ok<TX>(h, {x, dy, dx});
  const int threads = threads_for(vec ? h / V : h);
  const bool affine = w != nullptr;
  const size_t smem = affine ? kAcc * static_cast<size_t>(h) * sizeof(float) : 0;
  const TX* xp = static_cast<const TX*>(x);
  const TX* gp = static_cast<const TX*>(dy);
  const TW* wp = static_cast<const TW*>(w);
  TX* dxp = static_cast<TX*>(dx);
  float* pp = affine ? part : nullptr;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(bwd_kernel<kCentred, TX, TW, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    bwd_kernel<kCentred, TX, TW, true><<<parts, threads, smem, stream>>>(
        xp, gp, mu, rstd, wp, dxp, pp, rows, h);
  } else {
    err = cudaFuncSetAttribute(bwd_kernel<kCentred, TX, TW, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    bwd_kernel<kCentred, TX, TW, false><<<parts, threads, smem, stream>>>(
        xp, gp, mu, rstd, wp, dxp, pp, rows, h);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !affine) return err;
  column_sum_kernel<TW><<<(kAcc * h + 255) / 256, 256, 0, stream>>>(
      part, static_cast<TW*>(dw), static_cast<TW*>(db), parts, h, kAcc * h);
  return cudaGetLastError();
}

template <bool kCentred, typename TX>
cudaError_t bwd_w(const void* x, const void* dy, const float* mu,
                  const float* rstd, const void* w, int w_dtype, void* dx,
                  void* dw, void* db, float* part, int rows, int h, int parts,
                  cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch_bwd<kCentred, TX, float>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, parts, stream);
    case kBFloat16: return launch_bwd<kCentred, TX, __nv_bfloat16>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, parts, stream);
    case kFloat16: return launch_bwd<kCentred, TX, __half>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h, parts, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x, dy, dx [rows, h] contiguous in x_dtype; mu (when kCentred), rstd
// [rows] fp32; w [h] in w_dtype or null (no affine: dw, db and part are
// then ignored); dw (and db when kCentred) [h] in w_dtype; part
// [parts, kAcc * h] fp32 scratch; 1 <= parts <= rows.
template <bool kCentred>
int bwd(const void* x, const void* dy, const void* mu, const void* rstd,
        const void* w, void* dx, void* dw, void* db, void* part, int rows,
        int h, int parts, int x_dtype, int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (parts < 1 || parts > rows) return cudaErrorInvalidValue;
  if (w == nullptr) w_dtype = x_dtype;
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return bwd_w<kCentred, float>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, parts, s);
    case kBFloat16: return bwd_w<kCentred, __nv_bfloat16>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, parts, s);
    case kFloat16: return bwd_w<kCentred, __half>(x, dy, m, r, w, w_dtype, dx, dw, db, p, rows, h, parts, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace row_norm
