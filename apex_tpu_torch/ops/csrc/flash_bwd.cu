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
// repeated or transposed in device memory.
//
// Bound: operations. At the training shape (2 x 2048, 32/8 heads of 128,
// causal: 134.3 M (q, k) pairs) dq is 6*d flop a pair (103 GFLOP, 0.104 ms
// at 989 TFLOP/s) and dk/dv 8*d (138 GFLOP, 0.139 ms), against ~0.2 GB of
// inputs and outputs.
//
// Design: the TPU's sequential grid axes become loops inside a CTA, so
// every sum stays in registers of one CTA and no atomics are needed.
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
// 153.3 KB for dk/dv at d = 128, one CTA an SM), after
// cudaFuncSetAttribute. The products are fp32 FMAs, as in the forward:
// this first kernel is right and simple and is held to the 67 TFLOP/s
// fp32 rate; mma.sync/wgmma and TMA are later work.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // dq: query rows per CTA
constexpr int kBK = 32;    // dq: keys per k tile
constexpr int kBKV = 64;   // dkv: keys per CTA
constexpr int kBQ2 = 32;   // dkv: query rows per q tile

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
};

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (D + 4) + 2 * D * (kBK + 4) + kBK * (D + 4) + kBQ * (kBK + 4);
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kBKV * (D + 4) + 2 * D * (kBQ2 + 4) + 2 * kBQ2 * (D + 4) +
         2 * kBKV * (kBQ2 + 4) + 2 * kBQ2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float qv = 0.f, ov = 0.f;
    if (q0 + r < p.sq && c < p.d) {
      qv = to_float(q[(q0 + r) * p.q_ss + c]);
      ov = to_float(dout[(q0 + r) * p.do_ss + c]);
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
        kv = to_float(k[(k0 + c) * p.k_ss + dd]);
        vv = to_float(v[(k0 + c) * p.v_ss + dd]);
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
        if (col < p.d) dq[q_pos * p.dq_ss + col] = from_float<T>(acc[i][jj * 4 + e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
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
  const T* k = static_cast<const T*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  T* dk = static_cast<T*>(p.dk) + bk * p.dk_sb + hk * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + bk * p.dv_sb + hk * p.dv_sh;

  for (int i = tid; i < kBKV * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < p.sk && c < p.d) {
      kv = to_float(k[(k0 + r) * p.k_ss + c]);
      vv = to_float(v[(k0 + r) * p.v_ss + c]);
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
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + hh * p.do_sh;
    for (int q0 = q_begin; q0 < p.sq; q0 += kBQ2) {
      __syncthreads();  // Ks/Vs written; last tile's reads done
      for (int i = tid; i < kBQ2 * D; i += kThreads) {
        const int c = i / D, dd = i % D;
        float qv = 0.f, ov = 0.f;
        if (q0 + c < p.sq && dd < p.d) {
          qv = to_float(q[(q0 + c) * p.q_ss + dd]);
          ov = to_float(dout[(q0 + c) * p.do_ss + dd]);
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
          dk[k_pos * p.dk_ss + col] = from_float<T>(dk_acc[i][jj * 4 + e]);
          dv[k_pos * p.dv_ss + col] = from_float<T>(dv_acc[i][jj * 4 + e]);
        }
      }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int bh_kv, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + kBKV - 1) / kBKV, bh_kv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int rows, bool dkv, cudaStream_t stream) {
  if (p.d <= 32) return dkv ? launch_dkv<T, 32>(p, rows, stream) : launch_dq<T, 32>(p, rows, stream);
  if (p.d <= 64) return dkv ? launch_dkv<T, 64>(p, rows, stream) : launch_dq<T, 64>(p, rows, stream);
  if (p.d <= 128) return dkv ? launch_dkv<T, 128>(p, rows, stream) : launch_dq<T, 128>(p, rows, stream);
  return cudaErrorInvalidValue;
}

int run(const Params& p, int rows, bool dkv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch<float>(p, rows, dkv, s);
    case kBFloat16: return dispatch<__nv_bfloat16>(p, rows, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout/dq are [B, sq, H, d] and k/v/dk/dv [B_kv, sk, H_kv, d] views given
// by element strides (sb, ss, sh; the last dim is contiguous). The flat
// query row f = b*H + h reads kv row f / rep, split as (b_kv, h_kv) =
// divmod(f / rep, H_kv); kv row g gathers the query rows g*rep + r. lse and
// delta are [B*H, sq] fp32. dtype: 0 float32, 1 bfloat16 (common.cuh).
// flash_bwd_dq launches over bh = B*H query rows, flash_bwd_dkv over
// bh_kv = B_kv*H_kv kv rows.
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
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, scale};
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
           dv_sb, dv_ss, dv_sh, scale};
  return run(p, bh_kv, true, dtype, stream);
}
