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
//
// amax finishes inside the kernel, so a cast is one launch and its caller
// zeroes nothing. Each block folds its threads' maxima (__reduce_max_sync,
// then one shared-memory step) and writes them to its own slot of a
// scratch buffer; the block that finishes last, found by an atomicInc on
// the buffer's counter word that wraps back to 0 by itself, takes the max
// of the slots and writes amax. The counter is 0 before and after every
// launch, with nothing kept on the host, so a launch can be captured in a
// CUDA graph (and the count holds for any grid up to the slots); the wrapper keeps one buffer per device and stream (two
// streams casting at once must not share a counter), zeroed once when it
// is made. One atomic a block: atomics on one word serialise (one a warp
// took the [512, 4096] activation's cast from 0.0071 to 0.0117 ms on an
// H100 before the blocks folded their own maxima).
//
// Bound: bytes. n * (sizeof(x) + 1) bytes move (x read once, y written
// once); a few operations an element. For the Llama-3-8B gate weight
// [4096, 14336] in bf16 that is 176 MB, 0.053 ms at 3.35 TB/s; for a
// 512-token activation [512, 4096], 6.3 MB, 0.0019 ms.
//
// Row-major output (fp8_cast_scale): each thread issues kVecs 16-byte
// loads of x (8 bf16 or fp16, 4 fp32) before its first convert, then
// stores each vector's 8 or 4 fp8 bytes at once; the grid gives a thread
// kVecs vectors a pass (a [512, 4096] bf16 activation: 256 blocks, one
// pass; a decode step's [8, 4096]: 4 blocks, whose launch is the cost) up
// to blocks_per_sm blocks an SM, which then loop. Threads a block and
// blocks an SM are the launch plan (apex_tpu_torch.tuning.geometry;
// untuned 256 and 8). The tail of n mod V
// elements, or all of x when a pointer is misaligned, goes one element a
// thread. Any n: the TPU's padding of x to a (rows, cols) slab has no
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
// vector or element, so any shape. Its amax finishes as the row-major
// kernel's does.

#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreadsT = 256;  // the column-major kernel's block
constexpr int kBlocksPerSmT = 8;  // its most blocks an SM
constexpr int kVecs = 4;  // 16-byte loads of x a thread has in flight

enum Fp8Code { kE4M3 = 0, kE5M2 = 1 };

// The in-kernel amax, in two calls every thread of the block makes:
// count_in folds the block's bits (__reduce_max_sync, then one
// shared-memory step) and, on a grid of several blocks, has thread 0
// write them to scratch[1 + blockIdx.x] and count the block in on
// scratch[0] with an atomicInc that wraps back to 0 at gridDim.x - 1
// increments, returning that thread's ticket; finish then lets the last
// block to count in fold every slot and write *amax. Work between the two
// calls overlaps the count. A grid of one block writes *amax in count_in,
// with no slot and no atomic. scratch holds 1 + gridDim.x words, its
// counter 0 at the launch.
template <int kThreads>
__device__ __forceinline__ unsigned count_in(unsigned bits,
                                             unsigned* __restrict__ amax,
                                             unsigned* __restrict__ scratch) {
  __shared__ unsigned warp_bits[kThreads / 32];
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned ticket = 0;
  if (threadIdx.x < 32) {
    bits = threadIdx.x < kThreads / 32 ? warp_bits[threadIdx.x] : 0u;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) {
      if (gridDim.x == 1) {
        *amax = bits;
      } else {
        scratch[1 + blockIdx.x] = bits;
        __threadfence();  // the slot is seen before the count
        ticket = atomicInc(scratch, gridDim.x - 1);
      }
    }
  }
  return ticket;
}

template <int kThreads>
__device__ __forceinline__ void finish(unsigned ticket,
                                       unsigned* __restrict__ amax,
                                       unsigned* __restrict__ scratch) {
  __shared__ unsigned warp_bits[kThreads / 32];
  __shared__ bool last;
  if (gridDim.x == 1) return;
  if (threadIdx.x == 0) last = ticket == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // every other block's slot was written before its count: read them
  // from L2 (__ldcg), past this SM's L1
  unsigned bits = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads)
    bits = max(bits, __ldcg(scratch + 1 + b));
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x < 32) {
    bits = threadIdx.x < kThreads / 32 ? warp_bits[threadIdx.x] : 0u;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) *amax = bits;
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

// clip(t, -fmax, fmax) with NaN kept: min.NaN and max.NaN return NaN when
// either input is NaN (fminf and fmaxf would drop it)
__device__ __forceinline__ float clip(float t, float fmax) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(t), "f"(fmax));
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(-fmax));
  return r;
}

// two fp32 values into two fp8 bytes, lo in the low byte, in one convert
// (the same rounding and saturation as __nv_cvt_float_to_fp8 with
// __NV_SATFINITE)
template <__nv_fp8_interpretation_t kFmt>
__device__ __forceinline__ uint32_t cvt_pair(float lo, float hi) {
  unsigned short r;
  if constexpr (kFmt == __NV_E4M3)
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  return r;
}

// the magnitudes of a 16-byte vector folded into m, from its raw bits:
// fp32 bits for fp32 x, two 16-bit magnitudes a word for 16-bit x (bf16
// and fp16 magnitudes, NaN above inf, order like their bits too)
template <typename T>
__device__ __forceinline__ void fold_magnitudes(const uint4& raw,
                                                unsigned& m) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (sizeof(T) == 4)
      m = max(m, w[c] & 0x7fffffffu);
    else
      m = __vmaxu2(m, w[c] & 0x7fff7fffu);
  }
}

// fold_magnitudes' m as the fp32 bits of the magnitude
template <typename T>
__device__ __forceinline__ unsigned magnitude_bits(unsigned m) {
  if constexpr (sizeof(T) == 4) {
    return m;
  } else {
    const unsigned short h =
        static_cast<unsigned short>(max(m & 0xffffu, m >> 16));
    if constexpr (std::is_same<T, __half>::value)
      return __float_as_uint(__half2float(__ushort_as_half(h)));
    else
      return static_cast<unsigned>(h) << 16;  // bf16 is fp32's top half
  }
}

// vector i of x (V elements) cast into V fp8 bytes at y + i * V, a pair
// of elements a convert
template <typename T, __nv_fp8_interpretation_t kFmt>
__device__ __forceinline__ void cast_vec(const uint4& raw, uint8_t* y,
                                         int64_t i, float s, float fmax) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  uint32_t word[V / 4] = {};
#pragma unroll
  for (int j = 0; j < V; j += 2)
    word[j / 4] |= cvt_pair<kFmt>(clip(to_float(e[j]) * s, fmax),
                                  clip(to_float(e[j + 1]) * s, fmax))
                   << (16 * ((j / 2) % 2));
  if constexpr (V == 8)
    reinterpret_cast<uint2*>(y)[i] = make_uint2(word[0], word[1]);
  else
    reinterpret_cast<uint32_t*>(y)[i] = word[0];
}

// A block takes kVecs vectors a thread a pass, each a block's width after
// the last, so a warp's loads are coalesced and all of a thread's are in
// flight before its first convert. On its last pass the block folds amax
// from the raw vectors and counts in before it converts, so the count
// (and the last block's wait for it) overlaps the converts and stores.
template <int kThreads, typename T, __nv_fp8_interpretation_t kFmt>
__global__ void __launch_bounds__(kThreads)
    cast_scale_kernel(const T* __restrict__ x, uint8_t* __restrict__ y,
                      int64_t n, bool vec, const float* __restrict__ scale_ptr,
                      float scale_value, float fmax,
                      unsigned* __restrict__ amax,
                      unsigned* __restrict__ scratch) {
  constexpr int V = 16 / sizeof(T);  // 8 or 4 elements a vector
  const float s = scale_ptr != nullptr ? *scale_ptr : scale_value;
  const int64_t nvec = vec ? n / V : 0;
  // the scalar part first: the n mod V tail, or all of x when misaligned
  unsigned bits = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = nvec * V + blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    y[i] = static_cast<uint8_t>(cast_one<kFmt>(to_float(x[i]), s, fmax, bits));

  const int64_t chunk = static_cast<int64_t>(kThreads) * kVecs;
  const int64_t step = static_cast<int64_t>(gridDim.x) * chunk;
  unsigned m = 0, ticket = 0;
  // a block with no vector counts in after the loop; the bound is on the
  // block's first vector, so the whole block runs the same passes
  const bool counts_late = blockIdx.x * chunk >= nvec;
  for (int64_t start = blockIdx.x * chunk; start < nvec; start += step) {
    uint4 raw[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int64_t i = start + k * kThreads + threadIdx.x;
      if (i < nvec) {
        raw[k] = reinterpret_cast<const uint4*>(x)[i];
        fold_magnitudes<T>(raw[k], m);
      }
    }
    if (start + step >= nvec)
      ticket = count_in<kThreads>(max(bits, magnitude_bits<T>(m)), amax,
                                  scratch);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int64_t i = start + k * kThreads + threadIdx.x;
      if (i < nvec) cast_vec<T, kFmt>(raw[k], y, i, s, fmax);
    }
  }
  if (counts_late) ticket = count_in<kThreads>(bits, amax, scratch);
  finish<kThreads>(ticket, amax, scratch);
}

// at most blocks_per_sm blocks an SM, and no more than the scratch's slots
cudaError_t grid_cap(int slots, int blocks_per_sm, int* cap) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *cap = sms * blocks_per_sm < slots ? sms * blocks_per_sm : slots;
  return err;
}

template <int kThreads, typename T>
cudaError_t launch(const void* x, void* y, int64_t n, int fp8,
                   const float* scale_ptr, float scale_value, float fmax,
                   unsigned* amax, unsigned* scratch, int slots,
                   int blocks_per_sm, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % V == 0;
  int cap = 0;
  const cudaError_t err = grid_cap(slots, blocks_per_sm, &cap);
  if (err != cudaSuccess) return err;
  // kVecs vectors a thread, or as many elements when x goes one at a time
  const int64_t work = vec ? n / V + n % V : n;
  const int64_t want = (work + kThreads * kVecs - 1) / (kThreads * kVecs);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const T* xp = static_cast<const T*>(x);
  uint8_t* yp = static_cast<uint8_t*>(y);
  if (fp8 == kE4M3)
    cast_scale_kernel<kThreads, T, __NV_E4M3><<<blocks, kThreads, 0, stream>>>(xp, yp, n, vec, scale_ptr, scale_value, fmax, amax, scratch);
  else
    cast_scale_kernel<kThreads, T, __NV_E5M2><<<blocks, kThreads, 0, stream>>>(xp, yp, n, vec, scale_ptr, scale_value, fmax, amax, scratch);
  return cudaGetLastError();
}

// the row-major cast's launch plan: threads a block (128, 256, 512 or
// 1024: the compiled instances) and the most blocks an SM
template <typename T>
cudaError_t launch_plan(const void* x, void* y, int64_t n, int fp8,
                        const float* scale_ptr, float scale_value, float fmax,
                        unsigned* amax, unsigned* scratch, int slots,
                        int threads, int blocks_per_sm, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch<128, T>(x, y, n, fp8, scale_ptr, scale_value, fmax, amax, scratch, slots, blocks_per_sm, stream);
    case 256: return launch<256, T>(x, y, n, fp8, scale_ptr, scale_value, fmax, amax, scratch, slots, blocks_per_sm, stream);
    case 512: return launch<512, T>(x, y, n, fp8, scale_ptr, scale_value, fmax, amax, scratch, slots, blocks_per_sm, stream);
    case 1024: return launch<1024, T>(x, y, n, fp8, scale_ptr, scale_value, fmax, amax, scratch, slots, blocks_per_sm, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kTileR = 128;  // rows of x a tile: bytes of a y^T row
constexpr int kTileC = 64;   // columns of x a tile: rows of y^T
constexpr int kTilePad = kTileR + 4;

template <typename T, __nv_fp8_interpretation_t kFmt>
__global__ void __launch_bounds__(kThreadsT)
    cast_scale_t_kernel(const T* __restrict__ x, uint8_t* __restrict__ yt,
                        int64_t rows, int64_t cols, bool vec,
                        const float* __restrict__ scale_ptr, float scale_value,
                        float fmax, unsigned* __restrict__ amax,
                        unsigned* __restrict__ scratch) {
  __shared__ __align__(4) uint8_t tile[kTileC][kTilePad];  // [col][row]
  const float s = scale_ptr != nullptr ? *scale_ptr : scale_value;
  const int64_t tiles_r = (rows + kTileR - 1) / kTileR;
  const int64_t tiles = tiles_r * ((cols + kTileC - 1) / kTileC);
  constexpr int V = 16 / sizeof(T);                      // elements a vector
  constexpr int kVecs = kTileR * kTileC / V / kThreadsT;  // vectors a thread
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
        const int v = i * kThreadsT + threadIdx.x;
        const int r = v / (kTileC / V), c = v % (kTileC / V) * V;
        in[i] = r0 + r < rows && c0 + c < cols;
        if (in[i])
          raw[i] = *reinterpret_cast<const uint4*>(x + (r0 + r) * cols +
                                                   c0 + c);
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int v = i * kThreadsT + threadIdx.x;
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
      for (int i = 0; i < kTileR * kTileC / kThreadsT; ++i) {
        const int idx = i * kThreadsT + threadIdx.x;
        const int r = idx / kTileC, c = idx % kTileC;
        if (r0 + r < rows && c0 + c < cols)
          tile[c][r] = static_cast<uint8_t>(cast_one<kFmt>(
              to_float(x[(r0 + r) * cols + c0 + c]), s, fmax, bits));
      }
    }
    __syncthreads();
    if (rows % 4 == 0) {  // whole words: r0 + 4w < rows puts all 4 in range
#pragma unroll
      for (int i = 0; i < kTileR * kTileC / 4 / kThreadsT; ++i) {
        const int idx = i * kThreadsT + threadIdx.x;
        const int c = idx / (kTileR / 4), w = idx % (kTileR / 4);
        if (c0 + c < cols && r0 + 4 * w < rows)
          *reinterpret_cast<uint32_t*>(yt + (c0 + c) * rows + r0 + 4 * w) =
              *reinterpret_cast<const uint32_t*>(&tile[c][4 * w]);
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < kTileR * kTileC / kThreadsT; ++i) {
        const int idx = i * kThreadsT + threadIdx.x;
        const int c = idx / kTileR, r = idx % kTileR;
        if (c0 + c < cols && r0 + r < rows)
          yt[(c0 + c) * rows + r0 + r] = tile[c][r];
      }
    }
    __syncthreads();  // the next tile's loads overwrite the tile
  }
  finish<kThreadsT>(count_in<kThreadsT>(bits, amax, scratch), amax,
                    scratch);
}

template <typename T>
cudaError_t launch_t(const void* x, void* yt, int64_t rows, int64_t cols,
                     int fp8, const float* scale_ptr, float scale_value,
                     float fmax, unsigned* amax, unsigned* scratch, int slots,
                     cudaStream_t stream) {
  int cap = 0;
  const cudaError_t err = grid_cap(slots, kBlocksPerSmT, &cap);
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
    cast_scale_t_kernel<T, __NV_E4M3><<<blocks, kThreadsT, 0, stream>>>(xp, yp, rows, cols, vec, scale_ptr, scale_value, fmax, amax, scratch);
  else
    cast_scale_t_kernel<T, __NV_E5M2><<<blocks, kThreadsT, 0, stream>>>(xp, yp, rows, cols, vec, scale_ptr, scale_value, fmax, amax, scratch);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous elements of dtype (common.cuh codes); y: n bytes of
// E4M3 (fp8 = 0) or E5M2 (fp8 = 1); the scale at scale_ptr (one fp32 on
// the device) or, when scale_ptr is null, scale_value; amax: one fp32 word
// on the device that receives max |x| (nothing need be in it); scratch:
// 1 + slots words on the device, the first (the blocks' counter) 0, as
// every launch leaves it; one launch on the stream at a time may use it;
// threads (128, 256, 512 or 1024) and blocks_per_sm (1 to 16): the launch
// plan (untuned: 256 and 8), cudaErrorInvalidValue for any other.
extern "C" int fp8_cast_scale(const void* x, void* y, long long n, int dtype,
                              int fp8, const void* scale_ptr,
                              float scale_value, float fmax, void* amax,
                              void* scratch, int slots, int threads,
                              int blocks_per_sm, void* stream) {
  if (n < 1 || x == nullptr || y == nullptr || amax == nullptr ||
      scratch == nullptr || slots < 1 || (fp8 != kE4M3 && fp8 != kE5M2) ||
      blocks_per_sm < 1 || blocks_per_sm > 16 ||
      (threads != 128 && threads != 256 && threads != 512 &&
       threads != 1024))
    return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale_ptr);
  unsigned* ap = static_cast<unsigned*>(amax);
  unsigned* sc = static_cast<unsigned*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_plan<float>(x, y, n, fp8, sp, scale_value, fmax, ap, sc, slots, threads, blocks_per_sm, s);
    case kBFloat16: return launch_plan<__nv_bfloat16>(x, y, n, fp8, sp, scale_value, fmax, ap, sc, slots, threads, blocks_per_sm, s);
    case kFloat16: return launch_plan<__half>(x, y, n, fp8, sp, scale_value, fmax, ap, sc, slots, threads, blocks_per_sm, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: [rows, cols] row-major of dtype; yt: [cols, rows] row-major bytes
// (y column-major), rows * 4 bytes aligned when rows % 4 == 0; the other
// arguments as fp8_cast_scale's.
extern "C" int fp8_cast_scale_t(const void* x, void* yt, long long rows,
                                long long cols, int dtype, int fp8,
                                const void* scale_ptr, float scale_value,
                                float fmax, void* amax, void* scratch,
                                int slots, void* stream) {
  if (rows < 1 || cols < 1 || x == nullptr || yt == nullptr ||
      amax == nullptr || scratch == nullptr || slots < 1 ||
      (fp8 != kE4M3 && fp8 != kE5M2) ||
      (rows % 4 == 0 && reinterpret_cast<uintptr_t>(yt) % 4 != 0))
    return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale_ptr);
  unsigned* ap = static_cast<unsigned*>(amax);
  unsigned* sc = static_cast<unsigned*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_t<float>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, sc, slots, s);
    case kBFloat16: return launch_t<__nv_bfloat16>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, sc, slots, s);
    case kFloat16: return launch_t<__half>(x, yt, rows, cols, fp8, sp, scale_value, fmax, ap, sc, slots, s);
    default: return cudaErrorInvalidValue;
  }
}
