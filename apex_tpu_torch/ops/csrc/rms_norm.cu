// RMSNorm forward and backward for Hopper (sm_90a): norm.cuh's kernels
// without centring.
//
// rms_norm_fwd replaces apex_tpu/ops/layer_norm.py:56 _rms_fwd_kernel
// (launched by _rms_fwd_pallas, :127); rms_norm_bwd replaces :189
// _rms_bwd_kernel (launched by _rms_bwd_pallas, :282). norm.cuh gives the
// math and the design.
//
// Bound: bytes, both ways. The forward reads x and w and writes y (and 4
// bytes of rstd per row); the backward reads x, dy, rstd and w and writes
// dx and dw (100.7 MB, 0.030 ms at 3.35 TB/s, for 4096 x 4096 bf16). Each
// does a few flops per element, far below Hopper's ~295 flop/byte ridge.

#include "norm.cuh"

// x, y [rows, h] contiguous in dtype x_dtype; w [h] in w_dtype or null
// (no affine; w_dtype is then ignored); rstd [rows] fp32.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* rstd, int rows, int h, float eps,
                            int x_dtype, int w_dtype, void* stream) {
  return row_norm::fwd<false>(x, w, nullptr, y, nullptr, rstd, rows, h,
                              eps, x_dtype, w_dtype, stream);
}

// x, dy, dx [rows, h] contiguous in dtype x_dtype; rstd [rows] fp32; w [h]
// in w_dtype or null (no affine: dw and dw_part are then ignored); dw [h]
// in w_dtype; dw_part [parts, h] fp32 scratch; 1 <= parts <= rows.
extern "C" int rms_norm_bwd(const void* x, const void* dy, const void* rstd,
                            const void* w, void* dx, void* dw, void* dw_part,
                            int rows, int h, int parts, int x_dtype,
                            int w_dtype, void* stream) {
  return row_norm::bwd<false>(x, dy, nullptr, rstd, w, dx, dw, nullptr,
                              dw_part, rows, h, parts, x_dtype, w_dtype,
                              stream);
}
