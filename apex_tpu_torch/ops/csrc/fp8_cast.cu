// Fused fp8 cast-and-scale with the pre-scale amax, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/fp8_cast_kernel.py:31 _cast_scale_kernel (launched
// by _cast_and_scale_pallas, :59). For x of n elements (fp32, bf16 or fp16)
// and an fp32 scale s, in one pass over x:
//   y[i] = sat_cast(clip(f32(x[i]) * s, -fmax, fmax))   E4M3 or E5M2, RNE
//   amax = max_i |f32(x[i])|                             one fp32 scalar
// f32(x) * s is one fp32 multiply, the clip is exact and the convert rounds
// once (__nv_cvt_float_to_fp8 with __NV_SATFINITE), so y equals the plain
// version bit for bit; a max is exact, so amax does too.
//
// NaN: the reference's clip and max propagate NaN, where fminf and fmaxf
// would drop it. The clip is two compares, both false for NaN, so NaN
// reaches the convert and comes out as the format's NaN. amax is the
// maximum of the bit patterns of |x| as unsigned ints: a non-negative
// float orders like its bits, and a NaN with its sign cleared sorts above
// +inf, so the max of the bits is the max of the floats with NaN winning.
// Each block folds its threads' maxima with __reduce_max_sync and adds one
// atomicMax on those bits to a word the caller zeroed.
//
// Bound: bytes. n * (sizeof(x) + 1) bytes move (x read once, y written
// once); a few operations an element. For the Llama-3-8B gate weight
// [4096, 14336] in bf16 that is 176 MB, 0.053 ms at 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors of x (8 bf16 or fp16, 4
// fp32), each converted into 8 or 4 fp8 bytes stored at once; the tail of
// n mod V elements, or all of x when a pointer is misaligned, one element
// a thread. Any n: the TPU's padding of x to a (rows, cols) slab has no
// counterpart. The scale is read from device memory when the caller passes
// a pointer (a per-layer scale tensor stays on the card), else taken from
// the value argument.
//
// Column-major output (fp8_cast_scale_t): the same values for a 2-D x
// [rows, cols], written as y^T [cols, rows] row-major, which is y
// column-major: the layout cuBLASLt's fp8 GEMM takes for its second
// operand. Writing it here saves a second pass over the fp8 weight (a
// copy into that layout) on every product. A block takes tiles of 128
// rows x 64 columns of x in turn: coalesced loads along x's rows, 16
// bytes a thread and all of a thread's loads in flight at once when the
// rows are 16-byte aligned (else one element a thread), the fp8 bytes
// through shared memory (each tile row padded by 4 bytes against bank
// conflicts), coalesced stores along y^T's rows, 128 bytes a warp in
// 4-byte words when rows is a multiple of 4. Bounds are checked per
// vector or element, so any shape.
//
// Both kernels fold amax across the block before one atomicMax a block,
// on a grid of at most 8 blocks an SM: atomics on one word serialise. One
// a warp instead took the [512, 4096] activation's cast from 0.0071 to
// 0.0117 ms on an H100.

#include <cuda_fp8.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

enum Fp8Code { kE4M3 = 0, kE5M2 = 1 };

// max of the block's threads' bits, added to *amax by one atomicMax;
// every thread of the block must call it
__device__ __forceinline__ void block_atomic_max_bits(unsigned bits,
                                                      unsigned* amax) {
  __shared__ unsigned warp_bits[kThreads / 32];
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x < 32) {
    bits = threadIdx.x < kThreads / 32 ? warp_bits[threadIdx.x] : 0u;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) atomicMax(amax, bits);
  }
}

template <__nv_fp8_interpretation_t kFmt>
__device__ __forceinline__ uint32_t cast_one(float v, float s, float fmax,
                                             unsigned& amax_bits) {
  amax_bits = max(amax_bits, __float_as_uint(fabsf(v)));
  float t = v * s;
  t = t > fmax ? fmax : (t < -fmax ? -fmax : t);
  return __nv_cvt_float_to_fp8(t, __NV_SATFINITE, kFmt);
}

template <typename T, __nv_fp8_interpretation_t kFmt>
__global__ void __launch_bounds__(kThreads)
    cast_scale_kernel(const T* __restrict__ x, uint8_t* __restrict__ y,
                      int64_t n, bool vec, const float* __restrict__ scale_ptr,
                      float scale_value, float fmax,
                      unsigned* __restrict__ amax) {
  constexpr int V = 16 / sizeof(T);  // 8 or 4 elements a vector
  const float s = scale_ptr != nullptr ? *scale_ptr : scale_value;
  unsigned bits = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nvec = vec ? n / V : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint32_t word[V / 4] = {};
#pragma unroll
    for (int j = 0; j < V; ++j)
      word[j / 4] |= cast_one<kFmt>(to_float(e[j]), s, fmax, bits)
                     << (8 * (j % 4));
    if constexpr (V == 8)
      reinterpret_cast<uint2*>(y)[i] = make_uint2(word[0], word[1]);
    else
      reinterpret_cast<uint32_t*>(y)[i] = word[0];
  }
  for (int64_t i = nvec * V + tid; i < n; i += stride)
    y[i] = static_cast<uint8_t>(cast_one<kFmt>(to_float(x[i]), s, fmax, bits));
  block_atomic_max_bits(bits, amax);
}

cudaError_t grid_cap(int* cap) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *cap = sms * kBlocksPerSm;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, int fp8,
                   const float* scale_ptr, float scale_value, float fmax,
                   unsigned* amax, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % V == 0;
  int cap = 0;
  const cudaError_t err = grid_cap(&cap);
  if (err != cudaSuccess) return err;
  const int64_t work = vec ? n / V + n % V : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const T* xp = static_cast<const T*>(x);
  uint8_t* yp = static_cast<uint8_t*>(y);
  if (fp8 == kE4M3)
    cast_scale_kernel<T, __NV_E4M3><<<blocks, kThreads, 0, stream>>>(xp, yp, n, vec, scale_ptr, scale_value, fmax, amax);
  else
    cast_scale_kernel<T, __NV_E5M2><<<blocks, kThreads, 0, stream>>>(xp, yp, n, vec, scale_ptr, scale_value, fmax, amax);
  return cudaGetLastError();
}

constexpr int kTileR = 128;  // rows of x a tile: bytes of a y^T row
constexpr int kTileC = 64;   // columns of x a tile: rows of y^T
constexpr int kTilePad = kTileR + 4;

template <typename T, __nv_fp8_interpretation_t kFmt>
__global__ void __launch_bounds__(kThreads)
    cast_scale_t_kernel(const T* __restrict__ x, uint8_t* __restrict__ yt,
                        int64_t rows, int64_t cols, bool vec,
                        const float* __restrict__ scale_ptr, float scale_value,
                        float fmax, unsigned* __restrict__ amax) {
  __shared__ __align__(4) uint8_t tile[kTileC][kTilePad];  // [col][row]
  const float s = scale_ptr != nullptr ? *scale_ptr : scale_value;
  const int64_t tiles_r = (rows + kTileR - 1) / kTileR;
  const int64_t tiles = tiles_r * ((cols + kTileC - 1) / kTileC);
  constexpr int V = 16 / sizeof(T);                      // elements a vector
  constexpr int kVecs = kTileR * kTileC / V / kThreads;  // vectors a thread
  unsigned bits = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    // consecutive tiles run down a column band: y^T's rows fill in order
    const int64_t r0 = (t % tiles_r) * kTileR, c0 = (t / tiles_r) * kTileC;
    if (vec) {
      // every load of the tile in flight before the first convert
      uint4 raw[kVecs];
      bool in[kVecs];
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int v = i * kThreads + threadIdx.x;
        const int r = v / (kTileC / V), c = v % (kTileC / V) * V;
        in[i] = r0 + r < rows && c0 + c < cols;
        if (in[i])
          raw[i] = *reinterpret_cast<const uint4*>(x + (r0 + r) * cols +
                                                   c0 + c);
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int v = i * kThreads + threadIdx.x;
        const int r = v / (kTileC / V), c = v % (kTileC / V) * V;
        const T* e = reinterpret_cast<const T*>(&raw[i]);
        if (in[i]) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            tile[c + j][r] = static_cast<uint8_t>(
                cast_one<kFmt>(to_float(e[j]), s, fmax, bits));
        }
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < kTileR * kTileC / kThreads; ++i) {
        const int idx = i * kThreads + threadIdx.x;
        const int r = idx / kTileC, c = idx % kTileC;
        if (r0 + r < rows && c0 + c < cols)
          tile[c][r] = static_cast<uint8_t>(cast_one<kFmt>(
              to_float(x[(r0 + r) * cols + c0 + c]), s, fmax, bits));
      }
    }
    __syncthreads();
    if (rows % 4 == 0) {  // whole words: r0 + 4w < rows puts all 4 in range
#pragma unroll
      for (int i = 0; i < kTileR * kTileC / 4 / kThreads; ++i) {
        const int idx = i * kThreads + threadIdx.x;
        const int c = idx / (kTileR / 4), w = idx % (kTileR / 4);
        if (c0 + c < cols && r0 + 4 * w < rows)
          *reinterpret_cast<uint32_t*>(yt + (c0 + c) * rows + r0 + 4 * w) =
              *reinterpret_cast<const uint32_t*>(&tile[c][4 * w]);
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < kTileR * kTileC / kThreads; ++i) {
        const int idx = i * kThreads + threadIdx.x;
        const int c = idx / kTileR, r = idx % kTileR;
        if (c0 + c < cols && r0 + r < rows)
          yt[(c0 + c) * rows + r0 + r] = tile[c][r];
      }
    }
    __syncthreads();  // the next tile's loads overwrite the tile
  }
  block_atomic_max_bits(bits, amax);
}

template <typename T>
cudaError_t launch_t(const void* x, void* yt, int64_t rows, int64_t cols,
                     int fp8, const float* scale_ptr, float scale_value,
                     float fmax, unsigned* amax, cudaStream_t stream) {
  int cap = 0;
  const cudaError_t err = grid_cap(&cap);
  if (err != cudaSuccess) return err;
  const int64_t tiles =
      ((rows + kTileR - 1) / kTileR) * ((cols + kTileC - 1) / kTileC);
  const int blocks = static_cast<int>(tiles < cap ? tiles : cap);
  // 16-byte loads when every row of x starts on a 16-byte boundary
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   cols % (16 / sizeof(T)) == 0;
  const T* xp = static_cast<const T*>(x);
  uint8_t* yp = static_cast<uint8_t*>(yt);
  if (fp8 == kE4M3)
    cast_scale_t_kernel<T, __NV_E4M3><<<blocks, kThreads, 0, stream>>>(xp, yp, rows, cols, vec, scale_ptr, scale_value, fmax, amax);
  else
    cast_scale_t_kernel<T, __NV_E5M2><<<blocks, kThreads, 0, stream>>>(xp, yp, rows, cols, vec, scale_ptr, scale_value, fmax, amax);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous elements of dtype (common.cuh codes); y: n bytes of
// E4M3 (fp8 = 0) or E5M2 (fp8 = 1); the scale at scale_ptr (one fp32 on
// the device) or, when scale_ptr is null, scale_value; amax: one fp32 word
// on the device, zeroed by the caller, that receives max |x|.
extern "C" int fp8_cast_scale(const void* x, void* y, long long n, int dtype,
                              int fp8, const void* scale_ptr,
                              float scale_value, float fmax, void* amax,
                              void* stream) {
  if (n < 1 || x == nullptr || y == nullptr || amax == nullptr ||
      (fp8 != kE4M3 && fp8 != kE5M2))
    return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale_ptr);
  unsigned* ap = static_cast<unsigned*>(amax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(x, y, n, fp8, sp, scale_value, fmax, ap, s);
    case kBFloat16: return launch<__nv_bfloat16>(x, y, n, fp8, sp, scale_value, fmax, ap, s);
    case kFloat16: return launch<__half>(x, y, n, fp8, sp, scale_value, fmax, ap, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: [rows, cols] row-major of dtype; yt: [cols, rows] row-major bytes
// (y column-major), rows * 4 bytes aligned when rows % 4 == 0; the other
// arguments as fp8_cast_scale's.
extern "C" int fp8_cast_scale_t(const void* x, void* yt, long long rows,
                                long long cols, int dtype, int fp8,
                                const void* scale_ptr, float scale_value,
                                float fmax, void* amax, void* stream) {
  if (rows < 1 || cols < 1 || x == nullptr || yt == nullptr || amax == nullptr || (fp8 != kE4M3 && fp8 != kE5M2) ||
      (rows % 4 == 0 && reinterpret_cast<uintptr_t>(yt) % 4 != 0))
    return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale_ptr);
  unsigned* ap = static_cast<unsigned*>(amax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_t<float>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, s);
    case kBFloat16: return launch_t<__nv_bfloat16>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, s);
    case kFloat16: return launch_t<__half>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, s);
    default: return cudaErrorInvalidValue;
  }
}
