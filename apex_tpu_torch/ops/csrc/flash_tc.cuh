// Shared pieces of the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): the dropout keep mask, the 16-byte-copy test, and the
// tensor-core helpers of the bf16 kernels (namespace tc): swizzled tiles,
// cp.async copies, wgmma descriptors and instructions, and the mapping
// between a warpgroup's accumulator fragments and tile positions.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

// Attention dropout's keep mask: the murmur3 finaliser of the absolute
// (flat query row bh = b*H + h, query, key) coordinates and the seed, the
// counterpart of apex_tpu/ops/flash_attention.py:37 _keep_mask bit for bit
// (uint32 arithmetic wraps as JAX's does). Forward and backward kernels
// tile differently and recompute the same mask from the coordinates; no
// mask is stored. thr = min(int(p_drop * 2^31), 2^31 - 1); an element is
// kept when the hash's top 31 bits exceed it.
__device__ __forceinline__ bool keep_mask(uint32_t seed, uint32_t bh, uint32_t q_pos,
                                          uint32_t k_pos, uint32_t thr) {
  uint32_t x = k_pos * 0x9E3779B9u + q_pos * 0x85EBCA6Bu + bh * 0xC2B2AE35u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return static_cast<int32_t>(x >> 1) > static_cast<int32_t>(thr);
}

// The dropout arguments of an entry point as its kernels take them:
// thr as keep_mask wants it and the kept values' factor 1 / (1 - p_drop),
// both from p_drop in double, as the Python side computes them.
struct Dropout {
  int on;
  uint32_t seed, thr;
  float rscale;
};

inline Dropout make_dropout(uint32_t seed, double p_drop) {
  if (!(p_drop > 0.0)) return Dropout{0, 0u, 0u, 1.f};
  const double t = p_drop * 2147483648.0;
  const uint32_t thr = t >= 2147483647.0 ? 2147483647u : static_cast<uint32_t>(t);
  return Dropout{1, seed, thr, static_cast<float>(1.0 / (1.0 - p_drop))};
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The tensor-core kernels copy 16-byte chunks when d, every row, batch and
// head stride (in elements) is a multiple of 8 and every pointer is
// 16-byte aligned; other views take element copies in the same kernels.
inline bool vec_ok(int d, std::initializer_list<const void*> ptrs,
                   std::initializer_list<long long> strides) {
  if (d % 8) return false;
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: warp w owns rows 16w..16w+15
constexpr float kLog2e = 1.4426950408889634f;
// A [64][D] bf16 tile in shared memory is D / 64 blocks of 64 rows x 128 B
// in wgmma's 128-byte swizzle: the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of that row. Each block is 8 KB and 1024-byte aligned.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

// element offset of (r, c) in a swizzled [64][D] tile
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * 4096 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// the dynamic shared memory, rounded up to the swizzle's 1024 bytes
__device__ __forceinline__ char* smem_base(void* raw) {
  const uint32_t a = smem_addr(raw);
  return static_cast<char*>(raw) + (((a + 1023) & ~1023u) - a);
}

// 16 B (or 4 B) from device to shared memory; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for all but the newest N groups, then make this thread's shared
// memory writes visible to wgmma (the async proxy)
template <int N>
__device__ __forceinline__ void cp_async_wait_for_wgmma() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptors (128-byte swizzle, layout type 1 in bits 62-63):
// start address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(ptr) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand: rows [row0, row0 + N) of a tile, columns 16kk..16kk+15
// (the reduction runs along the row). Rows step 128 B inside an 8-row
// group and 1024 B (SBO) between groups; the 32-byte column step stays
// inside the swizzle atom, whose XOR the hardware applies to the address.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0, int kk) {
  return desc(reinterpret_cast<const char*>(tile) + (kk >> 2) * 8192 + row0 * 128 +
                  (kk & 3) * 32,
              16, 1024);
}

// MN-major operand: rows [row0, row0 + 16) of a tile are the reduction,
// all D columns the N dimension (the tile read transposed): 8-row groups
// 1024 B apart (SBO), 64-column blocks 8192 B apart (LBO)
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int row0) {
  return desc(reinterpret_cast<const char*>(tile) + row0 * 128, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the async
// asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 32] += A[64 x 16] B[16 x 32]: A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (each warp's
// m16n8k16 A fragment of its 16 rows), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (each warp's
// m16n8k16 A fragment of its 16 rows), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// two fp32 values rounded once to bf16; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [n_rows, d] matrix (row stride ld_g
// elements, contiguous columns) into a swizzled [64][D] tile; rows >=
// n_rows and columns >= d read as 0. vec: 16-byte cp.async (d, the
// strides and the pointers 16-byte aligned); otherwise element copies.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld_g, int row0,
                                          int n_rows, int d, bool vec) {
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = row0 + r < n_rows && c < d;
      cp_async16(s + swz(r, c), ok ? g + (row0 + r) * ld_g + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      s[swz(r, c)] = (row0 + r < n_rows && c < d) ? g[(row0 + r) * ld_g + c]
                                                  : __float2bfloat16_rn(0.f);
    }
  }
}

// The epilogue's [64][D + 8] row-major staging tile (16 B of padding a
// row) into rows [row0, min(row0 + 64, n_rows)) and columns [0, d) of g.
template <int D>
__device__ __forceinline__ void store_tile(bf16* g, int64_t ld_g, int row0, int n_rows,
                                           int d, const bf16* s, bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (row0 + r < n_rows && c < d)
        *reinterpret_cast<uint4*>(g + (row0 + r) * ld_g + c) =
            *reinterpret_cast<const uint4*>(s + r * LD + c);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      if (row0 + r < n_rows && c < d) g[(row0 + r) * ld_g + c] = s[r * LD + c];
    }
  }
}

// The warpgroup's fp32 accumulators of a 64 x D block (warp w: rows 16w
// + lane/4 and + 8; n-tile j of 8 columns: registers 4j..4j+3, columns
// 8j + 2(lane%4) + {0, 1}) rounded once to bf16 into the staging tile.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* s, const float (&acc)[D / 2]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(s + (row0 + g + 8 * i) * LD + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// dQ or dV/dK += A B for one k-step, N = D
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}
}  // namespace tc
