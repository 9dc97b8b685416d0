// Flat-buffer fused Adam/AdamW step for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/fused_adam_kernel.py:35 _adam_kernel (launched by
// _adam_flat_pallas, :112). One elementwise pass over the 1-D per-dtype
// slab of every parameter:
//   g  = g + wd * p                       (L2 mode: adam_w == 0, wd != 0)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * g^2
//   u  = (m / c1) / (sqrt(v / c2) + eps)  (c1 = c2 = 1 without bias
//                                          correction: m, v unscaled)
//   u  = u + wd * p                       (AdamW mode: adam_w == 1, wd != 0)
//   delta = -lr * u                       stored in p's dtype
// g, m and v are fp32; p any float dtype. lr, c1 = 1 - b1^step and
// c2 = 1 - b2^step arrive as fp32 values computed by the wrapper, as the
// Pallas launcher computes them (fused_adam_kernel.py:121-126); (1 - b1)
// and (1 - b2) are rounded to fp32 once, as JAX's weak typing does.
//
// m and v are updated IN PLACE: the kernel reads and writes the same
// buffers, where the Pallas kernel writes new ones. At Llama-3-8B width
// with 4 layers (1.923 B parameters) a second m/v pair would add 15.4 GB.
//
// Bound: bytes. It reads g (4 B), p (2 B in bf16), m and v (8 B) and
// writes delta (2 B), m and v (8 B): 24 B an element for bf16 params,
// 46.2 GB for 1.923 B elements, 13.8 ms at 3.35 TB/s, against ~15 flops
// an element. Design: a grid-stride loop over groups of 4 elements with
// 16-byte loads and stores of g, m and v (and 8- or 16-byte ones of p and
// delta) when every pointer is aligned to its vector, a scalar loop for
// the tail and for unaligned slabs. The launch plan (threads a block, the
// most blocks) is an argument, chosen by apex_tpu_torch.tuning.geometry:
// untuned, 256 threads and at most 4096 blocks. Every product, sum, quotient and the
// square root are rounded on their own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): nvcc would otherwise contract a * b + c into one FMA, so
// the kernel differs from its plain version only where PyTorch's own
// elementwise kernels contract or round differently.

#include <cstdint>

#include "common.cuh"

namespace {

struct AdamArgs {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  int adam_w, bias_correction;
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T e[4];
};

__device__ __forceinline__ float adam_elem(float g, float p, float& m,
                                           float& v, const AdamArgs& a) {
  if (!a.adam_w && a.wd != 0.f) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  float mh = m, vh = v;
  if (a.bias_correction) {
    mh = __fdiv_rn(m, a.c1);
    vh = __fdiv_rn(v, a.c2);
  }
  float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps));
  if (a.adam_w && a.wd != 0.f) u = __fadd_rn(u, __fmul_rn(a.wd, p));
  return __fmul_rn(-a.lr, u);
}

template <int kThreads, typename TP, bool kVec>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ g, const TP* __restrict__ p,
            float* __restrict__ m, float* __restrict__ v,
            TP* __restrict__ delta, int64_t n, const AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      const Vec4<TP> pp = reinterpret_cast<const Vec4<TP>*>(p)[i];
      Vec4<TP> out;
      out.e[0] = from_float<TP>(adam_elem(gg.x, to_float(pp.e[0]), mm.x, vv.x, a));
      out.e[1] = from_float<TP>(adam_elem(gg.y, to_float(pp.e[1]), mm.y, vv.y, a));
      out.e[2] = from_float<TP>(adam_elem(gg.z, to_float(pp.e[2]), mm.z, vv.z, a));
      out.e[3] = from_float<TP>(adam_elem(gg.w, to_float(pp.e[3]), mm.w, vv.w, a));
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
      reinterpret_cast<Vec4<TP>*>(delta)[i] = out;
    }
    done = nv * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    delta[i] = from_float<TP>(adam_elem(g[i], to_float(p[i]), mi, vi, a));
    m[i] = mi;
    v[i] = vi;
  }
}

template <int kThreads, typename TP>
cudaError_t launch_t(const void* g, const void* p, void* m, void* v,
                     void* delta, int64_t n, const AdamArgs& a, int max_blocks,
                     cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % (4 * sizeof(TP)) == 0 &&
                   reinterpret_cast<uintptr_t>(delta) % (4 * sizeof(TP)) == 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < max_blocks ? (want > 0 ? want : 1) : max_blocks);
  const float* gp = static_cast<const float*>(g);
  const TP* pp = static_cast<const TP*>(p);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  TP* dp = static_cast<TP*>(delta);
  if (vec)
    adam_kernel<kThreads, TP, true><<<blocks, kThreads, 0, stream>>>(gp, pp, mp, vp, dp, n, a);
  else
    adam_kernel<kThreads, TP, false><<<blocks, kThreads, 0, stream>>>(gp, pp, mp, vp, dp, n, a);
  return cudaGetLastError();
}

// the launch plan: threads a block (128, 256, 512 or 1024: the compiled
// instances) and the most blocks; the grid is min(max_blocks, the blocks
// that give every thread one group of 4 elements, or one element on the
// scalar path)
template <typename TP>
cudaError_t launch(const void* g, const void* p, void* m, void* v,
                   void* delta, int64_t n, const AdamArgs& a, int threads,
                   int max_blocks, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch_t<128, TP>(g, p, m, v, delta, n, a, max_blocks, stream);
    case 256: return launch_t<256, TP>(g, p, m, v, delta, n, a, max_blocks, stream);
    case 512: return launch_t<512, TP>(g, p, m, v, delta, n, a, max_blocks, stream);
    case 1024: return launch_t<1024, TP>(g, p, m, v, delta, n, a, max_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// g, m, v: n fp32; p, delta: n in p_dtype (common.cuh codes); m and v are
// overwritten with their new values. omb1 = 1 - b1 and omb2 = 1 - b2 as
// fp32; adam_w: 1 decoupled weight decay (AdamW), 0 L2 into the gradient;
// threads (128, 256, 512 or 1024) and max_blocks (>= 1): the launch plan
// (untuned: 256 and 4096), cudaErrorInvalidValue for any other.
extern "C" int adam_flat(const void* g, const void* p, void* m, void* v,
                         void* delta, long long n, float lr, float c1,
                         float c2, float b1, float omb1, float b2,
                         float omb2, float eps, float wd, int adam_w,
                         int bias_correction, int p_dtype, int threads,
                         int max_blocks, void* stream) {
  if (max_blocks < 1 || (threads != 128 && threads != 256 &&
                         threads != 512 && threads != 1024))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const AdamArgs a{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, adam_w,
                   bias_correction};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p_dtype) {
    case kFloat32: return launch<float>(g, p, m, v, delta, n, a, threads, max_blocks, s);
    case kBFloat16: return launch<__nv_bfloat16>(g, p, m, v, delta, n, a, threads, max_blocks, s);
    case kFloat16: return launch<__half>(g, p, m, v, delta, n, a, threads, max_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}
