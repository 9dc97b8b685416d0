// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replaces apex_tpu/ops/flash_attention.py:261 _bwd_dq_kernel and :322
// _bwd_dkv_kernel (both launched by _flash_bwd_pallas, :393). With the
// forward's per-row lse and delta = rowsum(dO * O) (fp32, computed by the
// wrapper, as the JAX package leaves it to XLA outside the kernels), for
// every (query, key) pair of a batch*head row:
//   s  = scale * (q . k)            the Pallas backward scales after the
//                                   product (the forward scales q first)
//   p  = exp(s - lse),  0 where k_pos > q_pos (causal, top-left aligned),
//        k_pos >= sk or q_pos >= sq (tile padding)
//   dp = dO . v
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds * k               (dq kernel, stored in q's dtype)
//   dk = sum_q ds * q,  dv = sum_q p * dO
//                                   (dkv kernel, summed over the rep query
//                                   heads of each kv head; k/v's dtype)
// GQA: query head f reads kv head f / rep, as in the forward; nothing is
// repeated or transposed in device memory. Two kernels and no atomics:
// every sum is taken inside one CTA in a fixed order, so the outputs are
// bit-identical from run to run.
//
// Bound: operations. A causal pair costs 6*d flop in the dq kernel (S, dP,
// dQ) and 8*d in the dk/dv kernel (S, dP, dV, dK). At the training shape
// (2 x 2048, 32/8 heads of 128, causal: 134.3 M pairs) that is 103 GFLOP
// (0.104 ms at 989 TFLOP/s bf16) and 138 GFLOP (0.139 ms), against
// ~0.2 GB of inputs and outputs (0.06 ms at 3.35 TB/s).
//
// bf16 inputs: tensor cores (the flash_bwd_*_tc kernels below), one
// warpgroup (4 warps, 128 threads) a CTA.
//  - Every product is a wgmma (sm_90a) m64nNk16 bf16 x bf16 -> fp32, the
//    warpgroup's 64 rows at a time. Operands go from device memory to
//    shared memory as bf16 by cp.async (16 B a thread, zero-filled past
//    the ragged sq, sk and d edges) into tiles in wgmma's 128-byte
//    swizzle. S = Q K^T and dP = dO V^T (dq kernel; m64n64) and S^T = K
//    Q^T and dP^T = V dO^T (dk/dv kernel; m64n32) read both operands from
//    shared memory, K-major. The second products read A from registers
//    and B from the same tiles read transposed (MN-major, the
//    instruction's transpose bit): dQ += dS K, dV += P^T dO and
//    dK += dS^T Q (m64n128 at d = 128).
//  - S and dP accumulate in fp32 registers, in two commit groups: p =
//    exp(s - lse) and its masks run on S's accumulator fragments while dP
//    is still in flight, then dS = p (dp - delta) scale. The one new
//    rounding: P and dS are rounded once to bf16 right there, in
//    registers, into the A fragments of the second products (a warp's
//    accumulators of n-tiles 2m, 2m+1 are its A fragment of k-step m),
//    with no trip through shared memory. dQ, dK and dV accumulate in fp32
//    registers and are rounded to bf16 once, at the end.
//  - dq: one CTA per (64-row q tile, batch*head). Q and dO stay resident;
//    K and V tiles of 64 keys stream through a 2-stage cp.async ring,
//    loaded one tile ahead, up to the diagonal. The longest causal rows
//    run first.
//  - dk/dv: one CTA per (64-key tile, batch*kv head). K and V stay
//    resident; Q, dO, lse and delta tiles of 64 queries stream through a
//    2-stage ring over the rep query heads and, within each, the q tiles
//    at or below the diagonal; each tile is taken in two halves of 32
//    queries to keep S^T and dP^T in registers beside dK and dV. 64-key
//    tiles give 512 CTAs at the training shape (a CTA's causal work falls
//    linearly with its key tile), and key tile 0, the heaviest, runs
//    first.
//  - Shared memory at d = 128: 97 KB (dq) and 98 KB (dk/dv) a CTA, so two
//    CTAs an SM (__launch_bounds__(128, 2): at most 255 registers; ptxas
//    gives 200 and 223, no spills). d <= 64 takes the 64-column tiles.
//  - Masks are evaluated per element only on the diagonal and ragged-edge
//    tiles; tiles wholly above the diagonal are never loaded.
//
// fp32 inputs: the flash_bwd_*_fp32_kernel FMA kernels (fp32 FMAs on fp32
// tiles staged in shared memory, one CTA an SM), for fp32 only. Tensor
// cores would round fp32 operands to TF32 or bf16, and the fp32 path is
// held to 2e-5 of the plain version.

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, sq]
  const float* delta;  // [B*H, sq]
  void* dq;
  void* dk;
  void* dv;
  int H, H_kv, rep, sq, sk, d, causal;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  float scale;
  int vec;  // tensor-core kernels: 16-byte copies (vec_ok below)
};

// ---------------------------------------------------------------------------
// fp32 on FMAs
//  - dq: one CTA of 256 threads per (64-row q tile, batch*head), looping
//    over the k tiles of 32 at or below the diagonal. Each thread owns 2
//    query rows x 4 keys of S and dP, and the same 2 rows x (d/8) columns
//    of dq, as the forward kernel does with o.
//  - dk/dv: one CTA of 256 threads per (64-key tile, batch*kv head),
//    looping over the rep query heads of that kv head and, inside, over
//    the q tiles of 32 at or below the diagonal. Each thread owns 2 keys x
//    4 queries of S^T and dP^T, and 2 keys x (d/8) columns of both dk and
//    dv, so the GQA sum is taken in one fixed order.
// Tiles are staged in fp32 in dynamic shared memory (127.5 KB for dq and
// 153.3 KB for dk/dv at d = 128), after cudaFuncSetAttribute.

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // dq: query rows per CTA
constexpr int kBK = 32;    // dq: keys per k tile
constexpr int kBKV = 64;   // dkv: keys per CTA
constexpr int kBQ2 = 32;   // dkv: query rows per q tile

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (D + 4) + 2 * D * (kBK + 4) + kBK * (D + 4) + kBQ * (kBK + 4);
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kBKV * (D + 4) + 2 * D * (kBQ2 + 4) + 2 * kBQ2 * (D + 4) +
         2 * kBKV * (kBQ2 + 4) + 2 * kBQ2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32_kernel(const Params p) {
  constexpr int LDQ = D + 4, LDT = kBK + 4, LDK = D + 4, LDS = kBK + 4;
  constexpr int NJ = D / 32;  // float4 column groups per thread in dq
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][LDQ]
  float* dOs = Qs + kBQ * LDQ;                  // [kBQ][LDQ]
  float* Kt = dOs + kBQ * LDQ;                  // [D][LDT], k transposed
  float* Vt = Kt + D * LDT;                     // [D][LDT], v transposed
  float* Ks = Vt + D * LDT;                     // [kBK][LDK]
  float* dSs = Ks + kBK * LDK;                  // [kBQ][LDS]

  const int tid = threadIdx.x;
  const int f = blockIdx.y;  // flat batch*head
  const int q0 = blockIdx.x * kBQ;
  const int b = f / p.H, hh = f % p.H;
  const int kvf = f / p.rep;  // GQA: kv row f / rep
  const int bk = kvf / p.H_kv, hk = kvf % p.H_kv;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  const float* k = static_cast<const float*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float qv = 0.f, ov = 0.f;
    if (q0 + r < p.sq && c < p.d) {
      qv = q[(q0 + r) * p.q_ss + c];
      ov = dout[(q0 + r) * p.do_ss + c];
    }
    Qs[r * LDQ + c] = qv;
    dOs[r * LDQ + c] = ov;
  }

  const int r0 = (tid >> 3) * 2;  // this thread's two query rows
  const int cg = (tid & 7) * 4;   // its four keys / first dq column
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + r0 + i;
    const bool in = q_pos < p.sq;
    lse_r[i] = in ? p.lse[static_cast<int64_t>(f) * p.sq + q_pos] : 0.f;
    dl_r[i] = in ? p.delta[static_cast<int64_t>(f) * p.sq + q_pos] : 0.f;
  }
  float acc[2][NJ * 4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) acc[i][j] = 0.f;

  // causal: k tiles wholly above this q tile's diagonal are skipped
  const int k_end = p.causal ? min(p.sk, q0 + kBQ) : p.sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Qs/dOs written; last tile's Kt/Vt/Ks/dSs reads done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < p.sk && dd < p.d) {
        kv = k[(k0 + c) * p.k_ss + dd];
        vv = v[(k0 + c) * p.v_ss + dd];
      }
      Kt[dd * LDT + c] = kv;
      Vt[dd * LDT + c] = vv;
      Ks[c * LDK + dd] = kv;
    }
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float a0 = Qs[r0 * LDQ + dd], a1 = Qs[(r0 + 1) * LDQ + dd];
      const float g0 = dOs[r0 * LDQ + dd], g1 = dOs[(r0 + 1) * LDQ + dd];
      const float4 kk = *reinterpret_cast<const float4*>(&Kt[dd * LDT + cg]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[dd * LDT + cg]);
      s[0][0] += a0 * kk.x; s[0][1] += a0 * kk.y; s[0][2] += a0 * kk.z; s[0][3] += a0 * kk.w;
      s[1][0] += a1 * kk.x; s[1][1] += a1 * kk.y; s[1][2] += a1 * kk.z; s[1][3] += a1 * kk.w;
      dp[0][0] += g0 * vv.x; dp[0][1] += g0 * vv.y; dp[0][2] += g0 * vv.z; dp[0][3] += g0 * vv.w;
      dp[1][0] += g1 * vv.x; dp[1][1] += g1 * vv.y; dp[1][2] += g1 * vv.z; dp[1][3] += g1 * vv.w;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + cg + j;
        float pij = expf(p.scale * s[i][j] - lse_r[i]);
        if ((p.causal && k_pos > q_pos) || k_pos >= p.sk || q_pos >= p.sq) pij = 0.f;
        dSs[(r0 + i) * LDS + cg + j] = pij * (dp[i][j] - dl_r[i]) * p.scale;
      }
    }
    __syncthreads();  // dSs complete

    for (int c = 0; c < kBK; ++c) {
      const float d0 = dSs[r0 * LDS + c], d1 = dSs[(r0 + 1) * LDS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[c * LDK + cg + 32 * jj]);
        acc[0][jj * 4 + 0] += d0 * kk.x; acc[0][jj * 4 + 1] += d0 * kk.y;
        acc[0][jj * 4 + 2] += d0 * kk.z; acc[0][jj * 4 + 3] += d0 * kk.w;
        acc[1][jj * 4 + 0] += d1 * kk.x; acc[1][jj * 4 + 1] += d1 * kk.y;
        acc[1][jj * 4 + 2] += d1 * kk.z; acc[1][jj * 4 + 3] += d1 * kk.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + r0 + i;
    if (q_pos >= p.sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg + 32 * jj + e;
        if (col < p.d) dq[q_pos * p.dq_ss + col] = acc[i][jj * 4 + e];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fp32_kernel(const Params p) {
  constexpr int LDK = D + 4, LDT = kBQ2 + 4, LDQ = D + 4, LDP = kBQ2 + 4;
  constexpr int NJ = D / 32;  // float4 column groups per thread in dk, dv
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBKV][LDK]
  float* Vs = Ks + kBKV * LDK;                  // [kBKV][LDK]
  float* Qt = Vs + kBKV * LDK;                  // [D][LDT], q transposed
  float* dOt = Qt + D * LDT;                    // [D][LDT], dO transposed
  float* Qs = dOt + D * LDT;                    // [kBQ2][LDQ]
  float* dOs = Qs + kBQ2 * LDQ;                 // [kBQ2][LDQ]
  float* Ps = dOs + kBQ2 * LDQ;                 // [kBKV][LDP], p^T
  float* dSs = Ps + kBKV * LDP;                 // [kBKV][LDP], ds^T
  float* lse_s = dSs + kBKV * LDP;              // [kBQ2]
  float* dl_s = lse_s + kBQ2;                   // [kBQ2]

  const int tid = threadIdx.x;
  const int g = blockIdx.y;  // flat batch*kv head
  const int k0 = blockIdx.x * kBKV;
  const int bk = g / p.H_kv, hk = g % p.H_kv;
  const float* k = static_cast<const float*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  float* dk = static_cast<float*>(p.dk) + bk * p.dk_sb + hk * p.dk_sh;
  float* dv = static_cast<float*>(p.dv) + bk * p.dv_sb + hk * p.dv_sh;

  for (int i = tid; i < kBKV * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < p.sk && c < p.d) {
      kv = k[(k0 + r) * p.k_ss + c];
      vv = v[(k0 + r) * p.v_ss + c];
    }
    Ks[r * LDK + c] = kv;
    Vs[r * LDK + c] = vv;
  }

  const int r0 = (tid >> 3) * 2;  // this thread's two keys
  const int cg = (tid & 7) * 4;   // its four queries / first dk, dv column
  float dk_acc[2][NJ * 4], dv_acc[2][NJ * 4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q tiles wholly above this k tile's diagonal are skipped
  const int q_begin = p.causal ? (k0 / kBQ2) * kBQ2 : 0;
  for (int r = 0; r < p.rep; ++r) {
    const int f = g * p.rep + r;  // flat query row of this kv head
    const int b = f / p.H, hh = f % p.H;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
    for (int q0 = q_begin; q0 < p.sq; q0 += kBQ2) {
      __syncthreads();  // Ks/Vs written; last tile's reads done
      for (int i = tid; i < kBQ2 * D; i += kThreads) {
        const int c = i / D, dd = i % D;
        float qv = 0.f, ov = 0.f;
        if (q0 + c < p.sq && dd < p.d) {
          qv = q[(q0 + c) * p.q_ss + dd];
          ov = dout[(q0 + c) * p.do_ss + dd];
        }
        Qt[dd * LDT + c] = qv;
        dOt[dd * LDT + c] = ov;
        Qs[c * LDQ + dd] = qv;
        dOs[c * LDQ + dd] = ov;
      }
      if (tid < kBQ2) {
        const bool in = q0 + tid < p.sq;
        const int64_t row = static_cast<int64_t>(f) * p.sq + q0 + tid;
        lse_s[tid] = in ? p.lse[row] : 0.f;
        dl_s[tid] = in ? p.delta[row] : 0.f;
      }
      __syncthreads();

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float a0 = Ks[r0 * LDK + dd], a1 = Ks[(r0 + 1) * LDK + dd];
        const float w0 = Vs[r0 * LDK + dd], w1 = Vs[(r0 + 1) * LDK + dd];
        const float4 qq = *reinterpret_cast<const float4*>(&Qt[dd * LDT + cg]);
        const float4 oo = *reinterpret_cast<const float4*>(&dOt[dd * LDT + cg]);
        s[0][0] += a0 * qq.x; s[0][1] += a0 * qq.y; s[0][2] += a0 * qq.z; s[0][3] += a0 * qq.w;
        s[1][0] += a1 * qq.x; s[1][1] += a1 * qq.y; s[1][2] += a1 * qq.z; s[1][3] += a1 * qq.w;
        dp[0][0] += w0 * oo.x; dp[0][1] += w0 * oo.y; dp[0][2] += w0 * oo.z; dp[0][3] += w0 * oo.w;
        dp[1][0] += w1 * oo.x; dp[1][1] += w1 * oo.y; dp[1][2] += w1 * oo.z; dp[1][3] += w1 * oo.w;
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k_pos = k0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q_pos = q0 + cg + j;
          float pij = expf(p.scale * s[i][j] - lse_s[cg + j]);
          if ((p.causal && k_pos > q_pos) || q_pos >= p.sq || k_pos >= p.sk) pij = 0.f;
          Ps[(r0 + i) * LDP + cg + j] = pij;
          dSs[(r0 + i) * LDP + cg + j] = pij * (dp[i][j] - dl_s[cg + j]) * p.scale;
        }
      }
      __syncthreads();  // Ps, dSs complete

      for (int c = 0; c < kBQ2; ++c) {
        const float p0 = Ps[r0 * LDP + c], p1 = Ps[(r0 + 1) * LDP + c];
        const float d0 = dSs[r0 * LDP + c], d1 = dSs[(r0 + 1) * LDP + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 oo = *reinterpret_cast<const float4*>(&dOs[c * LDQ + cg + 32 * jj]);
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[c * LDQ + cg + 32 * jj]);
          dv_acc[0][jj * 4 + 0] += p0 * oo.x; dv_acc[0][jj * 4 + 1] += p0 * oo.y;
          dv_acc[0][jj * 4 + 2] += p0 * oo.z; dv_acc[0][jj * 4 + 3] += p0 * oo.w;
          dv_acc[1][jj * 4 + 0] += p1 * oo.x; dv_acc[1][jj * 4 + 1] += p1 * oo.y;
          dv_acc[1][jj * 4 + 2] += p1 * oo.z; dv_acc[1][jj * 4 + 3] += p1 * oo.w;
          dk_acc[0][jj * 4 + 0] += d0 * qq.x; dk_acc[0][jj * 4 + 1] += d0 * qq.y;
          dk_acc[0][jj * 4 + 2] += d0 * qq.z; dk_acc[0][jj * 4 + 3] += d0 * qq.w;
          dk_acc[1][jj * 4 + 0] += d1 * qq.x; dk_acc[1][jj * 4 + 1] += d1 * qq.y;
          dk_acc[1][jj * 4 + 2] += d1 * qq.z; dk_acc[1][jj * 4 + 3] += d1 * qq.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k_pos = k0 + r0 + i;
    if (k_pos >= p.sk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg + 32 * jj + e;
        if (col < p.d) {
          dk[k_pos * p.dk_ss + col] = dk_acc[i][jj * 4 + e];
          dv[k_pos * p.dv_ss + col] = dv_acc[i][jj * 4 + e];
        }
      }
  }
}

template <int D>
cudaError_t launch_dq_fp32(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_bwd_dq_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_fp32(const Params& p, int bh_kv, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + kBKV - 1) / kBKV, bh_kv);
  flash_bwd_dkv_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const Params& p, int rows, bool dkv, cudaStream_t stream) {
  if (p.d <= 32) return dkv ? launch_dkv_fp32<32>(p, rows, stream) : launch_dq_fp32<32>(p, rows, stream);
  if (p.d <= 64) return dkv ? launch_dkv_fp32<64>(p, rows, stream) : launch_dq_fp32<64>(p, rows, stream);
  if (p.d <= 128) return dkv ? launch_dkv_fp32<128>(p, rows, stream) : launch_dq_fp32<128>(p, rows, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: warp w owns rows 16w..16w+15
constexpr int kBQ = 64;   // query rows: the dq CTA's tile, dk/dv's streamed tile
constexpr int kBK = 64;   // keys: the dk/dv CTA's tile, dq's streamed tile
constexpr int kSub = 32;  // dk/dv: queries of one softmax step
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kBQ, "one thread per lse and delta entry");

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

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO; K, V x 2 stages; alignment
  return 6 * tile_bytes<D>() + 1024;
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V; Q, dO x 2 stages; lse, delta x 2
  return 6 * tile_bytes<D>() + 4 * kBQ * sizeof(float) + 1024;
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tc_kernel(const Params p) {
  constexpr int KS = D / 16, T = tile_bytes<D>() / 2;  // T: elements a tile
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_base(smem_tc));  // [64][D]
  bf16* dOs = Qs + T;                                      // [64][D]
  bf16* Ks = dOs + T;                                      // [2][64][D]
  bf16* Vs = Ks + 2 * T;                                   // [2][64][D]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_w = 16 * (threadIdx.x >> 5);  // this warp's first row
  const int f = blockIdx.x;                   // flat batch*head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal rows first
  const int b = f / p.H, hh = f % p.H;
  const int kvf = f / p.rep;  // GQA: kv row f / rep
  const int bk = kvf / p.H_kv, hk = kvf % p.H_kv;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;
  const bool vec = p.vec;

  // causal: k tiles wholly above this q tile's diagonal are skipped
  const int k_end = p.causal ? min(p.sk, q0 + kBQ) : p.sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  load_tile<D>(Qs, q, p.q_ss, q0, p.sq, p.d, vec);
  load_tile<D>(dOs, dout, p.do_ss, q0, p.sq, p.d, vec);
  load_tile<D>(Ks, k, p.k_ss, 0, p.sk, p.d, vec);
  load_tile<D>(Vs, v, p.v_ss, 0, p.sk, p.d, vec);
  cp_async_commit();

  // lse (in log2 units) and delta of this thread's two rows
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + row_w + g + 8 * i;
    const bool in = q_pos < p.sq;
    lse_r[i] = in ? p.lse[static_cast<int64_t>(f) * p.sq + q_pos] * kLog2e : 0.f;
    dl_r[i] = in ? p.delta[static_cast<int64_t>(f) * p.sq + q_pos] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // the next K, V tile, one ahead
      const int st = (kt + 1) & 1;
      load_tile<D>(Ks + st * T, k, p.k_ss, (kt + 1) * kBK, p.sk, p.d, vec);
      load_tile<D>(Vs + st * T, v, p.v_ss, (kt + 1) * kBK, p.sk, p.d, vec);
    }
    cp_async_commit();
    cp_async_wait_for_wgmma<1>();
    __syncthreads();  // tile kt landed for every thread
    const bf16* Kt = Ks + (kt & 1) * T;
    const bf16* Vt = Vs + (kt & 1) * T;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys (warp w: rows 16w..)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, desc_k(Qs, 0, kk), desc_k(Kt, 0, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dp, desc_k(dOs, 0, kk), desc_k(Vt, 0, kk));
    wgmma_commit();

    // the softmax step on the fragments: p while dP is still in flight,
    // then dS, rounded once to bf16 into the A fragments of dQ += dS K
    // (n-tiles 2m, 2m+1 -> k-step m)
    wgmma_wait<1>();
    fence_regs(s);
    const int k0 = kt * kBK;
    const bool edge = (p.causal && k0 + kBK > q0) || k0 + kBK > p.sk || q0 + kBQ > p.sq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pij = exp2f(fmaf(s[4 * j + e], scale_log2, -lse_r[i]));
        if (edge) {
          const int q_pos = q0 + row_w + g + 8 * i;
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          if ((p.causal && k_pos > q_pos) || k_pos >= p.sk || q_pos >= p.sq) pij = 0.f;
        }
        s[4 * j + e] = pij;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = s[4 * j + e] * (dp[4 * j + e] - dl_r[e >> 1]) * p.scale;
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: B (16 keys x D) is K read transposed (MN-major)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, da[kk], desc_mn(Kt, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait_for_wgmma<0>();
  __syncthreads();

  bf16* stage = reinterpret_cast<bf16*>(smem_base(smem_tc));  // [64][D + 8]
  stage_rows<D>(stage, acc);
  __syncthreads();
  store_tile<D>(dq, p.dq_ss, q0, p.sq, p.d, stage, vec);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tc_kernel(const Params p) {
  constexpr int KS = D / 16, T = tile_bytes<D>() / 2;
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_base(smem_tc));  // [64][D]
  bf16* Vs = Ks + T;                                       // [64][D]
  bf16* Qs = Vs + T;                                       // [2][64][D]
  bf16* dOs = Qs + 2 * T;                                  // [2][64][D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T);    // [2][64]
  float* dl_s = lse_s + 2 * kBQ;                           // [2][64]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = 16 * (tid >> 5);  // this warp's first key of the k tile
  const int gk = blockIdx.x;          // flat batch*kv head
  const int k0 = blockIdx.y * kBK;    // key tile 0, the most causal work, first
  const int bk = gk / p.H_kv, hk = gk % p.H_kv;
  const bf16* k = static_cast<const bf16*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  bf16* dk = static_cast<bf16*>(p.dk) + bk * p.dk_sb + hk * p.dk_sh;
  bf16* dv = static_cast<bf16*>(p.dv) + bk * p.dv_sb + hk * p.dv_sh;
  const bool vec = p.vec;

  // causal: q tiles wholly above this k tile's diagonal are skipped. The
  // CTA walks (query head r, q tile) in one sequence of n_it tiles.
  const int q_begin = p.causal ? (k0 / kBQ) * kBQ : 0;
  const int n_per = q_begin < p.sq ? (p.sq - q_begin + kBQ - 1) / kBQ : 0;
  const int n_it = p.rep * n_per;

  // Q, dO, lse and delta of tile it into ring stage it & 1
  auto load_q_tile = [&](int it) {
    const int f = gk * p.rep + it / n_per;  // flat query row of this kv head
    const int q0 = q_begin + (it % n_per) * kBQ;
    const int b = f / p.H, hh = f % p.H;
    const int st = it & 1;
    load_tile<D>(Qs + st * T, static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh,
                 p.q_ss, q0, p.sq, p.d, vec);
    load_tile<D>(dOs + st * T,
                 static_cast<const bf16*>(p.dout) + b * p.do_sb + hh * p.do_sh, p.do_ss,
                 q0, p.sq, p.d, vec);
    const int i = tid & (kBQ - 1);
    const bool in = q0 + i < p.sq;
    const float* src = (tid < kBQ ? p.lse : p.delta) + static_cast<int64_t>(f) * p.sq;
    cp_async4((tid < kBQ ? lse_s : dl_s) + st * kBQ + i, in ? src + q0 + i : src, in);
  };

  load_tile<D>(Ks, k, p.k_ss, k0, p.sk, p.d, vec);
  load_tile<D>(Vs, v, p.v_ss, k0, p.sk, p.d, vec);
  if (n_it > 0) load_q_tile(0);
  cp_async_commit();
  const float scale_log2 = p.scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q_tile(it + 1);
    cp_async_commit();
    cp_async_wait_for_wgmma<1>();
    __syncthreads();  // tile it landed for every thread
    const int st = it & 1;
    const int q0 = q_begin + (it % n_per) * kBQ;
    const bf16* Qt = Qs + st * T;
    const bf16* dOt = dOs + st * T;
    const float* lse_t = lse_s + st * kBQ;
    const float* dl_t = dl_s + st * kBQ;
    const bool edge = (p.causal && q0 < k0 + kBK) || q0 + kBQ > p.sq || k0 + kBK > p.sk;

#pragma unroll
    for (int sub = 0; sub < kBQ / kSub; ++sub) {
      const int qs = sub * kSub;  // the half's first query in the tile
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wgmma_ss_n32(s, desc_k(Ks, 0, kk), desc_k(Qt, qs, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss_n32(dp, desc_k(Vs, 0, kk), desc_k(dOt, qs, kk));
      wgmma_commit();

      // the softmax step: P while dP^T is still in flight, then dS; both
      // rounded once to bf16 into the A fragments of dV += P^T dO and
      // dK += dS^T Q
      wgmma_wait<1>();
      fence_regs(s);
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs + 8 * j + 2 * t + (e & 1);  // query within the tile
          float pij = exp2f(fmaf(s[4 * j + e], scale_log2, -lse_t[qc] * kLog2e));
          if (edge) {
            const int k_pos = k0 + row_w + g + 8 * (e >> 1), q_pos = q0 + qc;
            if ((p.causal && k_pos > q_pos) || q_pos >= p.sq || k_pos >= p.sk) pij = 0.f;
          }
          s[4 * j + e] = pij;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsv[e] = s[4 * j + e] * (dp[4 * j + e] - dl_t[qs + 8 * j + 2 * t + (e & 1)]) *
                   p.scale;
        da[j >> 1][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // B (16 queries x D) is the dO or Q tile read transposed (MN-major)
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_rs<D>(dv_acc, pa[kk], desc_mn(dOt, qs + 16 * kk));
        wgmma_rs<D>(dk_acc, da[kk], desc_mn(Qt, qs + 16 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait_for_wgmma<0>();
  __syncthreads();

  bf16* stage = reinterpret_cast<bf16*>(smem_base(smem_tc));  // 2 x [64][D + 8]
  stage_rows<D>(stage, dk_acc);
  stage_rows<D>(stage + 64 * (D + 8), dv_acc);
  __syncthreads();
  store_tile<D>(dk, p.dk_ss, k0, p.sk, p.d, stage, vec);
  store_tile<D>(dv, p.dv_ss, k0, p.sk, p.d, stage + 64 * (D + 8), vec);
}

template <int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kBQ - 1) / kBQ);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int bh_kv, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh_kv, (p.sk + kBK - 1) / kBK);
  flash_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// d <= 64 pads to the 64-column tile (one swizzle block), d <= 128 to two
cudaError_t dispatch(const Params& p, int rows, bool dkv, cudaStream_t stream) {
  if (p.d <= 64) return dkv ? launch_dkv<64>(p, rows, stream) : launch_dq<64>(p, rows, stream);
  if (p.d <= 128) return dkv ? launch_dkv<128>(p, rows, stream) : launch_dq<128>(p, rows, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

int run(const Params& p, int rows, bool dkv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_fp32(p, rows, dkv, s);
    case kBFloat16: return tc::dispatch(p, rows, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The tensor-core kernels copy 16-byte chunks when d, every row, batch and
// head stride (in elements) is a multiple of 8 and every pointer is
// 16-byte aligned; other views take element copies in the same kernels.
bool vec_ok(int d, std::initializer_list<const void*> ptrs,
            std::initializer_list<long long> strides) {
  if (d % 8) return false;
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

}  // namespace

// q/dout/dq are [B, sq, H, d] and k/v/dk/dv [B_kv, sk, H_kv, d] views given
// by element strides (sb, ss, sh; the last dim is contiguous). The flat
// query row f = b*H + h reads kv row f / rep, split as (b_kv, h_kv) =
// divmod(f / rep, H_kv); kv row g gathers the query rows g*rep + r. lse and
// delta are [B*H, sq] fp32. dtype: 0 float32 (FMA kernels), 1 bfloat16
// (tensor-core kernels) (common.cuh). flash_bwd_dq launches over bh = B*H
// query rows, flash_bwd_dkv over bh_kv = B_kv*H_kv kv rows.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int H,
                            int H_kv, int rep, int sq, int sk, int d,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            long long dq_sb, long long dq_ss, long long dq_sh,
                            float scale, int causal, int dtype, void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), dq, nullptr, nullptr,
           H, H_kv, rep, sq, sk, d, causal,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, scale,
           0};
  p.vec = vec_ok(d, {q, k, v, dout, dq},
                 {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh});
  return run(p, bh, false, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int bh_kv, int H, int H_kv, int rep, int sq,
                             int sk, int d,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long do_sb, long long do_ss, long long do_sh,
                             long long dk_sb, long long dk_ss, long long dk_sh,
                             long long dv_sb, long long dv_ss, long long dv_sh,
                             float scale, int causal, int dtype, void* stream) {
  if (bh_kv == 0 || sk == 0) return cudaSuccess;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), nullptr, dk, dv,
           H, H_kv, rep, sq, sk, d, causal,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, 0, 0, 0, dk_sb, dk_ss, dk_sh,
           dv_sb, dv_ss, dv_sh, scale, 0};
  p.vec = vec_ok(d, {q, k, v, dout, dk, dv},
                 {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,
                  dv_sh});
  return run(p, bh_kv, true, dtype, stream);
}
