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
//        k_pos >= kv_len (varlen, :300/:362), k_pos >= sk or q_pos >= sq
//        (tile padding); always selected, never multiplied: a row with
//        kv_len = 0 has lse = -1e30 and exp(s - lse) = inf
//   dp = dO . v,  and with dropout (:305-311, :362-378)
//        dp = keep ? dp / (1 - p_drop) : 0,  pm = keep ? p / (1 - p_drop) : 0
//        (keep_mask of flash_tc.cuh at the same coordinates as the forward)
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds * k               (dq kernel, stored in q's dtype)
//   dk = sum_q ds * q,  dv = sum_q pm * dO
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
//    tiles; tiles wholly above the diagonal or past kv_len are never
//    loaded (dq: key tiles; dk/dv: the query heads whose row sees no key of
//    the CTA's tile, and a CTA left with nothing writes zeros). The keep
//    mask is hashed while the second product of the pair is in flight and
//    kept as one bit an element for dS.
//
// fp32 inputs: the flash_bwd_*_fp32_kernel FMA kernels (fp32 FMAs on fp32
// tiles staged in shared memory, one CTA an SM), for fp32 only. Tensor
// cores would round fp32 operands to TF32 or bf16, and the fp32 path is
// held to 2e-5 of the plain version.

#include "flash_tc.cuh"

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
  int vec;  // tensor-core kernels: 16-byte copies (vec_ok, flash_tc.cuh)
  const int* kv_lens;  // [B*H] keys of each flat query row, or null: all sk
  Dropout drop;        // flash_tc.cuh
};

// the keys flat query row f attends to: kv_lens[f] clamped to [0, sk]
__device__ __forceinline__ int row_keys(const Params& p, int f) {
  return p.kv_lens ? max(0, min(p.kv_lens[f], p.sk)) : p.sk;
}

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

  // causal: k tiles wholly above this q tile's diagonal are skipped;
  // varlen: so are the tiles past the row's keys
  const int kv_len = row_keys(p, f);
  const int k_end = p.causal ? min(kv_len, q0 + kBQ) : kv_len;
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
        if ((p.causal && k_pos > q_pos) || k_pos >= kv_len || q_pos >= p.sq) pij = 0.f;
        float dpij = dp[i][j];
        if (p.drop.on)  // dL/dp of the dropped probabilities
          dpij = keep_mask(p.drop.seed, f, q_pos, k_pos, p.drop.thr) ? dpij * p.drop.rscale : 0.f;
        dSs[(r0 + i) * LDS + cg + j] = pij * (dpij - dl_r[i]) * p.scale;
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
    const int kv_len = row_keys(p, f);
    if (k0 >= kv_len) continue;   // varlen: no key of this tile is seen
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
          if ((p.causal && k_pos > q_pos) || q_pos >= p.sq || k_pos >= kv_len) pij = 0.f;
          float pm = pij, dpij = dp[i][j];
          if (p.drop.on) {  // dV takes the dropped p, dS the dropped dp
            const bool kp = keep_mask(p.drop.seed, f, q_pos, k_pos, p.drop.thr);
            pm = kp ? pij * p.drop.rscale : 0.f;
            dpij = kp ? dpij * p.drop.rscale : 0.f;
          }
          Ps[(r0 + i) * LDP + cg + j] = pm;
          dSs[(r0 + i) * LDP + cg + j] = pij * (dpij - dl_s[cg + j]) * p.scale;
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

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on tensor cores

namespace tc {

constexpr int kBQ = 64;   // query rows: the dq CTA's tile, dk/dv's streamed tile
constexpr int kBK = 64;   // keys: the dk/dv CTA's tile, dq's streamed tile
constexpr int kSub = 32;  // dk/dv: queries of one softmax step
static_assert(kThreads == 2 * kBQ, "one thread per lse and delta entry");

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO; K, V x 2 stages; alignment
  return 6 * tile_bytes<D>() + 1024;
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V; Q, dO x 2 stages; lse, delta x 2
  return 6 * tile_bytes<D>() + 4 * kBQ * sizeof(float) + 1024;
}

// kDrop: the dropout branch, compiled only into its own instances so that
// the dense kernels carry none of its registers or instructions
template <int D, bool kDrop>
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

  // causal: k tiles wholly above this q tile's diagonal are skipped;
  // varlen: so are the tiles past the row's keys, and keys past kv_len
  // read as zeros
  const int kv_len = row_keys(p, f);
  const int k_end = p.causal ? min(kv_len, q0 + kBQ) : kv_len;
  const int n_kt = (k_end + kBK - 1) / kBK;
  load_tile<D>(Qs, q, p.q_ss, q0, p.sq, p.d, vec);
  load_tile<D>(dOs, dout, p.do_ss, q0, p.sq, p.d, vec);
  if (n_kt > 0) {
    load_tile<D>(Ks, k, p.k_ss, 0, kv_len, p.d, vec);
    load_tile<D>(Vs, v, p.v_ss, 0, kv_len, p.d, vec);
  }
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
      load_tile<D>(Ks + st * T, k, p.k_ss, (kt + 1) * kBK, kv_len, p.d, vec);
      load_tile<D>(Vs + st * T, v, p.v_ss, (kt + 1) * kBK, kv_len, p.d, vec);
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
    const bool edge = (p.causal && k0 + kBK > q0) || k0 + kBK > kv_len || q0 + kBQ > p.sq;
    uint32_t kept = 0;  // dropout: bit 4j + e of the keep mask
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pij = exp2f(fmaf(s[4 * j + e], scale_log2, -lse_r[i]));
        if (edge) {
          const int q_pos = q0 + row_w + g + 8 * i;
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          if ((p.causal && k_pos > q_pos) || k_pos >= kv_len || q_pos >= p.sq) pij = 0.f;
        }
        s[4 * j + e] = pij;
        if constexpr (kDrop) {
          const int q_pos = q0 + row_w + g + 8 * i;
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          kept |= static_cast<uint32_t>(keep_mask(p.drop.seed, f, q_pos, k_pos, p.drop.thr))
                  << (4 * j + e);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dpij = dp[4 * j + e];
        if constexpr (kDrop) dpij = (kept >> (4 * j + e)) & 1u ? dpij * p.drop.rscale : 0.f;
        ds[e] = s[4 * j + e] * (dpij - dl_r[e >> 1]) * p.scale;
      }
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

template <int D, bool kDrop>
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

  // causal: q tiles wholly above this k tile's diagonal are skipped;
  // varlen: so are the query heads r whose row sees no key of this tile.
  // The CTA walks (query head r, q tile) in one sequence of n_it tiles.
  const int q_begin = p.causal ? (k0 / kBQ) * kBQ : 0;
  const int n_per = q_begin < p.sq ? (p.sq - q_begin + kBQ - 1) / kBQ : 0;
  int n_heads = p.rep;
  if (p.kv_lens) {
    n_heads = 0;
    for (int r = 0; r < p.rep; ++r) n_heads += k0 < row_keys(p, gk * p.rep + r);
  }
  const int n_it = n_heads * n_per;
  // the flat query row of the a-th query head walked
  auto row_of = [&](int a) {
    if (!p.kv_lens) return gk * p.rep + a;
    int r = 0;
    for (;; ++r)
      if (k0 < row_keys(p, gk * p.rep + r) && a-- == 0) break;
    return gk * p.rep + r;
  };

  // Q, dO, lse and delta of tile it into ring stage it & 1
  auto load_q_tile = [&](int it) {
    const int f = row_of(it / n_per);  // flat query row of this kv head
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

  if (n_it > 0) {  // else dK and dV are zeros
    load_tile<D>(Ks, k, p.k_ss, k0, p.sk, p.d, vec);
    load_tile<D>(Vs, v, p.v_ss, k0, p.sk, p.d, vec);
    load_q_tile(0);
  }
  cp_async_commit();
  const float scale_log2 = p.scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // tile it is q tile qi of the a-th query head walked, flat row f
  int a = 0, qi = 0, f = n_it > 0 ? row_of(0) : 0;
  int kv_len = row_keys(p, f);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q_tile(it + 1);
    cp_async_commit();
    cp_async_wait_for_wgmma<1>();
    __syncthreads();  // tile it landed for every thread
    const int st = it & 1;
    const int q0 = q_begin + qi * kBQ;
    const bf16* Qt = Qs + st * T;
    const bf16* dOt = dOs + st * T;
    const float* lse_t = lse_s + st * kBQ;
    const float* dl_t = dl_s + st * kBQ;
    const bool edge = (p.causal && q0 < k0 + kBK) || q0 + kBQ > p.sq || k0 + kBK > kv_len;

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
      // dK += dS^T Q. In the transposed tile the row is the key and the
      // column the query. Dropout: dV takes the dropped P, dS the dropped dP.
      wgmma_wait<1>();
      fence_regs(s);
      uint32_t pa[2][4], da[2][4];
      uint32_t kept = 0;  // dropout: bit 4j + e of the keep mask
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs + 8 * j + 2 * t + (e & 1);  // query within the tile
          float pij = exp2f(fmaf(s[4 * j + e], scale_log2, -lse_t[qc] * kLog2e));
          if (edge) {
            const int k_pos = k0 + row_w + g + 8 * (e >> 1), q_pos = q0 + qc;
            if ((p.causal && k_pos > q_pos) || q_pos >= p.sq || k_pos >= kv_len) pij = 0.f;
          }
          s[4 * j + e] = pm[e] = pij;
          if constexpr (kDrop) {
            const int k_pos = k0 + row_w + g + 8 * (e >> 1), q_pos = q0 + qc;
            const bool kp = keep_mask(p.drop.seed, f, q_pos, k_pos, p.drop.thr);
            kept |= static_cast<uint32_t>(kp) << (4 * j + e);
            pm[e] = kp ? pij * p.drop.rscale : 0.f;
          }
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(pm[0], pm[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pm[2], pm[3]);
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpij = dp[4 * j + e];
          if constexpr (kDrop) dpij = (kept >> (4 * j + e)) & 1u ? dpij * p.drop.rscale : 0.f;
          dsv[e] = s[4 * j + e] * (dpij - dl_t[qs + 8 * j + 2 * t + (e & 1)]) * p.scale;
        }
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
    if (++qi == n_per && it + 1 < n_it) {
      qi = 0;
      f = row_of(++a);
      kv_len = row_keys(p, f);
    }
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

template <int D, bool kDrop>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + kBQ - 1) / kBQ);
  flash_bwd_dq_tc_kernel<D, kDrop><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_dkv(const Params& p, int bh_kv, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh_kv, (p.sk + kBK - 1) / kBK);
  flash_bwd_dkv_tc_kernel<D, kDrop><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int rows, bool dkv, cudaStream_t stream) {
  if (p.drop.on)
    return dkv ? launch_dkv<D, true>(p, rows, stream) : launch_dq<D, true>(p, rows, stream);
  return dkv ? launch_dkv<D, false>(p, rows, stream) : launch_dq<D, false>(p, rows, stream);
}

// d <= 64 pads to the 64-column tile (one swizzle block), d <= 128 to two
cudaError_t dispatch(const Params& p, int rows, bool dkv, cudaStream_t stream) {
  if (p.d <= 64) return launch_d<64>(p, rows, dkv, stream);
  if (p.d <= 128) return launch_d<128>(p, rows, dkv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

namespace {

int run(const Params& p, int rows, bool dkv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_fp32(p, rows, dkv, s);
    case kBFloat16: return tc::dispatch(p, rows, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout/dq are [B, sq, H, d] and k/v/dk/dv [B_kv, sk, H_kv, d] views given
// by element strides (sb, ss, sh; the last dim is contiguous). The flat
// query row f = b*H + h reads kv row f / rep, split as (b_kv, h_kv) =
// divmod(f / rep, H_kv); kv row g gathers the query rows g*rep + r. lse and
// delta are [B*H, sq] fp32. kv_lens (int32 [B*H], or null) bounds the keys
// of each flat query row; p_drop > 0 drops probabilities with the keep mask
// of seed (flash_tc.cuh), as the forward did. dtype: 0 float32 (FMA
// kernels), 1 bfloat16 (tensor-core kernels) (common.cuh). flash_bwd_dq
// launches over bh = B*H query rows, flash_bwd_dkv over bh_kv = B_kv*H_kv
// kv rows.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int H,
                            int H_kv, int rep, int sq, int sk, int d,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            long long dq_sb, long long dq_ss, long long dq_sh,
                            float scale, int causal, const void* kv_lens,
                            unsigned int seed, double p_drop, int dtype,
                            void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), dq, nullptr, nullptr,
           H, H_kv, rep, sq, sk, d, causal,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, scale,
           0, static_cast<const int*>(kv_lens), make_dropout(seed, p_drop)};
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
                             float scale, int causal, const void* kv_lens,
                            unsigned int seed, double p_drop, int dtype,
                            void* stream) {
  if (bh_kv == 0 || sk == 0) return cudaSuccess;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), nullptr, dk, dv,
           H, H_kv, rep, sq, sk, d, causal,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, 0, 0, 0, dk_sb, dk_ss, dk_sh,
           dv_sb, dv_ss, dv_sh, scale, 0, static_cast<const int*>(kv_lens),
           make_dropout(seed, p_drop)};
  p.vec = vec_ok(d, {q, k, v, dout, dk, dv},
                 {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,
                  dv_sh});
  return run(p, bh_kv, true, dtype, stream);
}
