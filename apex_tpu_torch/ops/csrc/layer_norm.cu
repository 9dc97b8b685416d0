// LayerNorm forward and backward for Hopper (sm_90a): norm.cuh's kernels
// with centring, the bias and db.
//
// layer_norm_fwd replaces apex_tpu/ops/layer_norm.py:40 _ln_fwd_kernel
// (launched by _ln_fwd_pallas, :94); layer_norm_bwd replaces :163
// _ln_bwd_kernel (launched by _ln_bwd_pallas, :239). norm.cuh gives the
// math and the design.
//
// Bound: bytes, both ways. The forward reads x, w and b and writes y (and
// 8 bytes of mu and rstd per row): 33.6 MB, 0.010 ms at 3.35 TB/s, for
// GPT-2's 8192 x 1024 bf16. The backward reads x, dy, mu, rstd and w and
// writes dx, dw and db: 50.4 MB, 0.015 ms. A few flops per element, far
// below Hopper's ~295 flop/byte ridge.

#include "norm.cuh"

// x, y [rows, h] contiguous in dtype x_dtype; w, b [h] in w_dtype, both or
// neither (no affine; w_dtype is then ignored); mu, rstd [rows] fp32.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mu, void* rstd, int rows, int h,
                              float eps, int x_dtype, int w_dtype,
                              void* stream) {
  if ((w == nullptr) != (b == nullptr)) return cudaErrorInvalidValue;
  return row_norm::fwd<true>(x, w, b, y, mu, rstd, rows, h, eps, x_dtype,
                             w_dtype, stream);
}

// x, dy, dx [rows, h] contiguous in dtype x_dtype; mu, rstd [rows] fp32;
// w [h] in w_dtype or null (no affine: dw, db and part are then ignored);
// dw, db [h] in w_dtype; part [parts, 2h] fp32 scratch; 1 <= parts <= rows.
extern "C" int layer_norm_bwd(const void* x, const void* dy, const void* mu,
                              const void* rstd, const void* w, void* dx,
                              void* dw, void* db, void* part, int rows, int h,
                              int parts, int x_dtype, int w_dtype,
                              void* stream) {
  return row_norm::bwd<true>(x, dy, mu, rstd, w, dx, dw, db, part, rows, h,
                             parts, x_dtype, w_dtype, stream);
}
