// Flash-attention forward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/flash_attention.py:65 _fwd_kernel (launched by
// _flash_fwd_pallas, :152). For every (batch*head, query) row:
//   s   = scale * (q . k^T)
//   s   = -1e30 where k_pos > q_pos (causal, top-left aligned),
//         k_pos >= kv_len (varlen, :91/:107) or k_pos >= sk (key padding)
//   online softmax over k tiles: m, l, acc in fp32; p = 0 exactly where
//   s was masked; l sums the raw p and is clamped at 1e-30
//   dropout (:121-124): acc takes keep ? p / (1 - p_drop) : 0, with the
//   keep mask of flash_tc.cuh at the absolute (row, query, key)
//   coordinates, which the backward kernels recompute
//   o   = acc / l   (stored in q's dtype),  lse = m + log(l)  (fp32)
// GQA: query head f reads kv head f / rep directly, with no repeated K/V.
// A row with kv_len = 0 gives o = 0 and lse = -1e30.
//
// Bound: operations at training lengths, bytes at short prefills. A
// causal pair costs 4*d flop (S and P V). At the training shape (2 x 2048,
// 32/8 heads of 128: 134.3 M pairs) that is 68.8 GFLOP, 0.0695 ms at 989
// TFLOP/s bf16, against 0.07 GB of q/k/v/o/lse (0.02 ms at 3.35 TB/s); a
// causal 512-token prompt is 2.15 GFLOP against 10.5 MB (205 flop/byte,
// below the H100's ridge of ~295), so short prefills are bound by bytes.
//
// bf16 inputs: tensor cores (flash_fwd_tc_kernel), one warpgroup (4 warps,
// 128 threads) a CTA and one CTA per (64-row q tile, batch*head), the
// longest causal rows first.
//  - Q's 64 x D tile stays resident in shared memory in wgmma's 128-byte
//    swizzle. K and V tiles of 64 keys stream through a 2-stage cp.async
//    ring (16-byte copies, zero-filled past sk, kv_len and d), loaded one
//    tile ahead, up to the causal diagonal and ceil(kv_len / 64): tiles
//    wholly above it or past kv_len are never loaded.
//  - S = Q K^T is a wgmma m64n64k16 with both operands from shared memory,
//    K-major, accumulated in fp32 registers. S is scaled in fp32 after the
//    product (JAX scales q first, :97; that would round q * scale to bf16
//    here) and masked per element on diagonal and ragged tiles only.
//  - The online (m, l) update runs on the accumulator fragments: each row
//    of the tile lives on the 4 lanes of a quad, so the row max is two
//    quad shuffles; l stays a per-thread partial sum until the end.
//  - P (dropped or not) is rounded once to bf16 into the A fragments of
//    O += P V (a warp's accumulators of n-tiles 2m, 2m+1 are its A fragment
//    of k-step m), a wgmma m64nDk16 with B = the V tile read MN-major (the
//    instruction's transpose bit), as the dq kernel's dS K. O accumulates in
//    fp32 registers and is rounded once at the end through a shared-memory
//    staging tile.
//  - One barrier a step: it finds tile kt landed for every thread and tile
//    kt - 1's stage free, and the next tile's copies start right after it.
//    Each step is S, its softmax, then P V, with no overlap inside the
//    warpgroup: issuing S of tile kt + 1 beside P V of tile kt made ptxas
//    serialise every wgmma (C7514: the softmax reads S's accumulators while
//    P V is in flight), which was slower on the H100 than this order; the
//    other CTA on the SM fills the gaps.
//  - The dropout branch is a template instance of its own (the hash costs
//    registers and instructions the dense kernel does not carry).
//  - Shared memory at d = 128: 81 KB a CTA (Q, K x 2, V x 2), two CTAs an
//    SM (__launch_bounds__(128, 2): O is 64 fp32 registers a thread beside
//    S's 32 and P's 16; ptxas gives 188 registers, no spills). d <= 64
//    takes 64-column tiles (BERT's heads), d <= 128 two.
//
// fp32 inputs: flash_fwd_fp32_kernel, fp32 FMAs on fp32 tiles in shared
// memory (tensor cores would round fp32 operands; the fp32 path is held to
// 2e-5 of the plain version). One CTA of 256 threads per (q tile of 64
// rows, batch*head) loops over k tiles of 32; each thread owns 2 query rows
// x 4 key columns of S and the same 2 rows x (d/8) columns of acc, so m, l
// and acc stay in registers and the row max/sum are 8-lane shuffles.

#include "flash_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, H_kv, rep, sq, sk, d, causal;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int vec;             // tensor-core kernel: 16-byte copies (vec_ok)
  const int* kv_lens;  // [B*H] keys of each flat query row, or null: all sk
  Dropout drop;        // flash_tc.cuh
};

// the keys flat query row f attends to: kv_lens[f] clamped to [0, sk]
__device__ __forceinline__ int row_keys(const Params& p, int f) {
  return p.kv_lens ? max(0, min(p.kv_lens[f], p.sk)) : p.sk;
}

// ---------------------------------------------------------------------------
// fp32 on FMAs

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per k tile
constexpr int kThreads = 256;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + D * (kBK + 4) + kBK * (D + 4) + kBQ * (kBK + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const Params p) {
  constexpr int LDQ = D + 4, LDK = kBK + 4, LDV = D + 4, LDP = kBK + 4;
  constexpr int NJ = D / 32;  // float4 column groups per thread in acc
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][LDQ], pre-scaled
  float* Kt = Qs + kBQ * LDQ;                   // [D][LDK], k transposed
  float* Vs = Kt + D * LDK;                     // [kBK][LDV]
  float* Ps = Vs + kBK * LDV;                   // [kBQ][LDP]

  const int tid = threadIdx.x;
  const int f = blockIdx.y;                     // flat batch*head
  const int q0 = blockIdx.x * kBQ;
  const int b = f / p.H, hh = f % p.H;
  const int kvf = f / p.rep;                    // GQA: kv row f / rep
  const int bk = kvf / p.H_kv, hk = kvf % p.H_kv;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < p.sq && c < p.d) val = q[(q0 + r) * p.q_ss + c] * p.scale;
    Qs[r * LDQ + c] = val;
  }

  const int r0 = (tid >> 3) * 2;  // this thread's two query rows
  const int cg = (tid & 7) * 4;   // its four key columns / first acc column
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[2][NJ * 4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) acc[i][j] = 0.f;

  // causal: k tiles wholly above this q tile's diagonal are skipped;
  // varlen: so are the tiles past the row's keys
  const int kv_len = row_keys(p, f);
  const int k_end = p.causal ? min(kv_len, q0 + kBQ) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Qs written; last tile's Kt/Vs/Ps reads finished
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < kv_len && dd < p.d) {
        kv = k[(k0 + c) * p.k_ss + dd];
        vv = v[(k0 + c) * p.v_ss + dd];
      }
      Kt[dd * LDK + c] = kv;
      Vs[c * LDV + dd] = vv;
    }
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float a0 = Qs[r0 * LDQ + dd], a1 = Qs[(r0 + 1) * LDQ + dd];
      const float4 kk = *reinterpret_cast<const float4*>(&Kt[dd * LDK + cg]);
      s[0][0] += a0 * kk.x; s[0][1] += a0 * kk.y; s[0][2] += a0 * kk.z; s[0][3] += a0 * kk.w;
      s[1][0] += a1 * kk.x; s[1][1] += a1 * kk.y; s[1][2] += a1 * kk.z; s[1][3] += a1 * kk.w;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + cg + j;
        if ((p.causal && k_pos > q_pos) || k_pos >= kv_len) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows with nothing allowed yet keep p exactly zero
        const float pj = s[i][j] <= kNegInf * 0.5f ? 0.f : expf(s[i][j] - m_new);
        float pv = pj;  // l sums the raw p, the numerator the dropped one
        if (p.drop.on)
          pv = keep_mask(p.drop.seed, f, q_pos, k0 + cg + j, p.drop.thr) ? pj * p.drop.rscale
                                                                         : 0.f;
        Ps[(r0 + i) * LDP + cg + j] = pv;
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ * 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // Ps complete

    for (int c = 0; c < kBK; ++c) {
      const float p0 = Ps[r0 * LDP + c], p1 = Ps[(r0 + 1) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * LDV + cg + 32 * jj]);
        acc[0][jj * 4 + 0] += p0 * vv.x; acc[0][jj * 4 + 1] += p0 * vv.y;
        acc[0][jj * 4 + 2] += p0 * vv.z; acc[0][jj * 4 + 3] += p0 * vv.w;
        acc[1][jj * 4 + 0] += p1 * vv.x; acc[1][jj * 4 + 1] += p1 * vv.y;
        acc[1][jj * 4 + 2] += p1 * vv.z; acc[1][jj * 4 + 3] += p1 * vv.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + r0 + i;
    if (q_pos >= p.sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg + 32 * jj + e;
        if (col < p.d) o[q_pos * p.o_ss + col] = acc[i][jj * 4 + e] / ll;
      }
    if ((tid & 7) == 0) p.lse[static_cast<int64_t>(f) * p.sq + q_pos] = m[i] + logf(ll);
  }
}

template <int D>
cudaError_t launch_fp32(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_fwd_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const Params& p, int bh, cudaStream_t stream) {
  if (p.d <= 32) return launch_fp32<32>(p, bh, stream);
  if (p.d <= 64) return launch_fp32<64>(p, bh, stream);
  if (p.d <= 128) return launch_fp32<128>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on tensor cores

namespace tc {

constexpr int kBQ = 64;  // query rows a CTA
constexpr int kBK = 64;  // keys a streamed K, V tile
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_smem_bytes() {  // Q; K, V x 2 stages; alignment
  return 5 * tile_bytes<D>() + 1024;
}

// kDrop: the dropout branch, compiled only into its own instance so that
// the dense kernel carries none of its registers or instructions
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tc_kernel(const Params p) {
  constexpr int KS = D / 16, T = tile_bytes<D>() / 2;  // T: elements a tile
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_base(smem_tc));  // [64][D]
  bf16* Ks = Qs + T;                                       // [2][64][D]
  bf16* Vs = Ks + 2 * T;                                   // [2][64][D]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_w = 16 * (threadIdx.x >> 5);  // this warp's first row
  const int f = blockIdx.x;                   // flat batch*head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal rows first
  const int b = f / p.H, hh = f % p.H;
  const int kvf = f / p.rep;  // GQA: kv row f / rep
  const int bk = kvf / p.H_kv, hk = kvf % p.H_kv;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const bool vec = p.vec;

  // causal: k tiles wholly above this q tile's diagonal are skipped;
  // varlen: so are the tiles past the row's keys, and keys past kv_len
  // read as zeros
  const int kv_len = row_keys(p, f);
  const int k_end = p.causal ? min(kv_len, q0 + kBQ) : kv_len;
  const int n_kt = (k_end + kBK - 1) / kBK;
  load_tile<D>(Qs, q, p.q_ss, q0, p.sq, p.d, vec);
  if (n_kt > 0) {
    load_tile<D>(Ks, k, p.k_ss, 0, kv_len, p.d, vec);
    load_tile<D>(Vs, v, p.v_ss, 0, kv_len, p.d, vec);
  }
  cp_async_commit();

  // this thread's two rows (16w + g and + 8): running max (log2 units),
  // partial sum of its own columns' p
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt landed for every thread, and every warp is done with tile
    // kt - 1, whose stage the next tile refills
    cp_async_wait_for_wgmma<0>();
    __syncthreads();
    if (kt + 1 < n_kt) {  // the next K, V tile, one ahead
      const int st = (kt + 1) & 1;
      load_tile<D>(Ks + st * T, k, p.k_ss, (kt + 1) * kBK, kv_len, p.d, vec);
      load_tile<D>(Vs + st * T, v, p.v_ss, (kt + 1) * kBK, kv_len, p.d, vec);
    }
    cp_async_commit();
    const bf16* Kt = Ks + (kt & 1) * T;
    const bf16* Vt = Vs + (kt & 1) * T;

    // S = Q K^T: 64 rows x 64 keys (warp w: rows 16w..)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, desc_k(Qs, 0, kk), desc_k(Kt, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale (log2 units), mask, and the tile's row max over the quad
    const int k0 = kt * kBK;
    const bool edge = (p.causal && k0 + kBK > q0) || k0 + kBK > kv_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int q_pos = q0 + row_w + g + 8 * i;
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          if ((p.causal && k_pos > q_pos) || k_pos >= kv_len) x = kNegInf;
        }
        s[4 * j + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }

    // p, exactly 0 where masked; l sums the raw p, the numerator takes the
    // dropped p, rounded once to bf16 into the A fragments of O += P V
    // (n-tiles 2m, 2m+1 -> k-step m)
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = s[4 * j + e];
        const float pr = x <= kNegInf * 0.5f ? 0.f : exp2f(x - m[i]);
        l[i] += pr;
        pv[e] = pr;
        if constexpr (kDrop) {
          const int q_pos = q0 + row_w + g + 8 * i;
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          pv[e] = keep_mask(p.drop.seed, f, q_pos, k_pos, p.drop.thr) ? pr * p.drop.rscale
                                                                      : 0.f;
        }
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }

    // O = alpha O + P V: B (16 keys x D) is the V tile read transposed
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mn(Vt, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait_for_wgmma<0>();
  __syncthreads();

  // the row sums over the quad; o = acc / l, lse = m + log(l) (natural
  // units; -1e30 for a row that saw no key, as the plain version gives)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= inv[e >> 1];
  bf16* stage = reinterpret_cast<bf16*>(smem_base(smem_tc));  // [64][D + 8]
  stage_rows<D>(stage, acc);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q0 + row_w + g + 8 * i;
      if (q_pos < p.sq)
        p.lse[static_cast<int64_t>(f) * p.sq + q_pos] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
    }
  }
  __syncthreads();
  store_tile<D>(o, p.o_ss, q0, p.sq, p.d, stage, vec);
}

template <int D, bool kDrop>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<D, kDrop><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int bh, cudaStream_t stream) {
  return p.drop.on ? launch<D, true>(p, bh, stream) : launch<D, false>(p, bh, stream);
}

// d <= 64 pads to the 64-column tile (one swizzle block), d <= 128 to two
cudaError_t dispatch(const Params& p, int bh, cudaStream_t stream) {
  if (p.d <= 64) return launch_d<64>(p, bh, stream);
  if (p.d <= 128) return launch_d<128>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// q/k/v/o are [B, S, H, d] views given by element strides (sb, ss, sh;
// the last dim is contiguous). The flat query row f = b*H + h reads kv row
// f / rep, split as (b_kv, h_kv) = divmod(f / rep, H_kv). lse is [B*H, sq]
// fp32. kv_lens (int32 [B*H], or null) bounds the keys of each flat query
// row; p_drop > 0 drops probabilities with the keep mask of seed
// (flash_tc.cuh). dtype: 0 float32 (FMA kernel), 1 bfloat16 (tensor-core
// kernel) (common.cuh).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int H, int H_kv,
                         int rep, int sq, int sk, int d,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, const void* kv_lens,
                         unsigned int seed, double p_drop, int dtype,
                         void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  Params p{q, k, v, o, static_cast<float*>(lse), H, H_kv, rep, sq, sk, d,
           causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, 0, static_cast<const int*>(kv_lens),
           make_dropout(seed, p_drop)};
  p.vec = vec_ok(d, {q, k, v, o},
                 {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  o_sb, o_ss, o_sh});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_fp32(p, bh, s);
    case kBFloat16: return tc::dispatch(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}
