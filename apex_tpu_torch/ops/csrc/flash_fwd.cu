// Flash-attention forward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/flash_attention.py:65 _fwd_kernel (launched by
// _flash_fwd_pallas, :152). For every (batch*head, query) row:
//   s   = (q * scale) . k^T          q scaled in fp32 before the product
//   s   = -1e30 where k_pos > q_pos (causal, top-left aligned) or
//         k_pos >= sk (key padding)
//   online softmax over k tiles: m, l, acc in fp32; p = 0 exactly where
//   s was masked; l clamped at 1e-30
//   o   = acc / l   (stored in q's dtype),  lse = m + log(l)  (fp32)
// GQA: query head f reads kv head f / rep directly, with no repeated K/V.
//
// Bound: operations at long prefills, bytes at short ones. A causal
// 512-token prompt with 32 query and 8 kv heads of 128 is 2.15 GFLOP per
// layer against 10.5 MB of q/k/v/o/lse, 205 flop/byte against the H100's
// ridge of ~295 in bf16; the work grows as s^2 and the bytes as s, so past
// about 740 tokens the tensor-core rate is the bound.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, batch*head); the
// TPU's sequential k grid axis becomes a loop inside the CTA over k tiles
// of 32, skipping tiles above the diagonal. Tiles are staged in dynamic
// shared memory in fp32 (76.5 KB at d = 128, so two CTAs share an SM);
// each thread owns 2 query rows x 4 key columns of S and the same 2 rows
// x (d/8) columns of the accumulator, so m, l and acc stay in registers
// and the row max/sum are 8-lane shuffles. q is read once and k/v once
// per q tile (mostly from L2), and S and P never leave the SM. The
// products are fp32 FMAs, not tensor cores: this first kernel is right
// and simple, and so is limited by the 67 TFLOP/s fp32 rate rather than
// by either bound; wgmma and TMA are later work. The TPU's 512x512 VMEM
// tiling is not carried over.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per k tile
constexpr int kThreads = 256;
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
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + D * (kBK + 4) + kBK * (D + 4) + kBQ * (kBK + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < p.sq && c < p.d) val = to_float(q[(q0 + r) * p.q_ss + c]) * p.scale;
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

  // causal: k tiles wholly above this q tile's diagonal are skipped
  const int k_end = p.causal ? min(p.sk, q0 + kBQ) : p.sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Qs written; last tile's Kt/Vs/Ps reads finished
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < p.sk && dd < p.d) {
        kv = to_float(k[(k0 + c) * p.k_ss + dd]);
        vv = to_float(v[(k0 + c) * p.v_ss + dd]);
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
        if ((p.causal && k_pos > q_pos) || k_pos >= p.sk) s[i][j] = kNegInf;
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
        Ps[(r0 + i) * LDP + cg + j] = pj;
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
        if (col < p.d) o[q_pos * p.o_ss + col] = from_float<T>(acc[i][jj * 4 + e] / ll);
      }
    if ((tid & 7) == 0) p.lse[static_cast<int64_t>(f) * p.sq + q_pos] = m[i] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int bh, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, bh, stream);
  if (p.d <= 64) return launch<T, 64>(p, bh, stream);
  if (p.d <= 128) return launch<T, 128>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/o are [B, S, H, d] views given by element strides (sb, ss, sh;
// the last dim is contiguous). The flat query row f = b*H + h reads kv row
// f / rep, split as (b_kv, h_kv) = divmod(f / rep, H_kv). lse is [B*H, sq]
// fp32. dtype: 0 float32, 1 bfloat16 (see common.cuh).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int H, int H_kv,
                         int rep, int sq, int sk, int d,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, int dtype, void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  Params p{q, k, v, o, static_cast<float*>(lse), H, H_kv, rep, sq, sk, d,
           causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_d<float>(p, bh, s);
    case kBFloat16: return dispatch_d<__nv_bfloat16>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}
