"""fp32-accumulator and fp8 contraction helpers (port of
``apex_tpu/ops/precision.py``).

:func:`matmul_fp32acc` and :func:`einsum_fp32acc` keep the storage dtype
of the result while the sums run in at least fp32. :func:`matmul_fp8`,
:func:`matmul_fp8_stats` and :func:`einsum_fp8` are the fp8 epilogues:
scale-in, saturating E4M3 cast (the fused cast kernel of
``fp8_cast_kernel``), a product with fp32 sums, scale-out. Their
backward quantizes the cotangent to E5M2 under ``grad_scale`` through the
same kernel and contracts it with the saved fp8 operands; the
``grad_probe`` scalar's gradient is the cotangent's pre-scale amax.

The fp8 product itself is no Pallas kernel in the reference
(``precision.py:146``, left to XLA). On the card the forward of
:func:`matmul_fp8` is ``torch._scaled_mm`` (cuBLASLt's fp8 GEMM) with
an fp32 result: it takes a row-major ``[M, K]`` and a column-major
``[K, N]`` operand with K and N multiples of 16, so the weight's cast
writes its fp8 bytes column-major (``col_major=True``; values
untouched). Every other fp8 product (the backward's,
:func:`einsum_fp8`'s, and all on the CPU) upcasts the fp8 operands to
fp32, which is exact, and sums in fp32.

:func:`matmul_amp` is the routing hook of the library's contraction
sites (the llama ``lm_head``, the tensor-parallel linears): the product
the site ran before amp existed until a step enters the O4 fp8 context
(``amp.scaler.Fp8DelayedScaler.step``), then an fp8 product at the sites
the scaler was built with.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import fp8_cast_kernel, kernel_config
from apex_tpu_torch.ops.fp8_cast_kernel import ScaleLike, as_scale

#: E4M3 for forward operands, E5M2 for backward cotangents
F8_E4M3 = torch.float8_e4m3fn
F8_E5M2 = torch.float8_e5m2

#: largest magnitudes: the saturation bounds (E4M3 has no inf encoding)
F8_E4M3_MAX = 448.0
F8_E5M2_MAX = 57344.0

_F8_MAX = {F8_E4M3: F8_E4M3_MAX, F8_E5M2: F8_E5M2_MAX}


def _acc_dtype(out_dtype: torch.dtype) -> torch.dtype:
    if not out_dtype.is_floating_point:
        return out_dtype  # integer or bool contraction: left as it is
    return torch.promote_types(out_dtype, torch.float32)


def matmul_fp32acc(a, b, *, keep_acc: bool = False):
    """``torch.matmul`` with the sums in at least fp32; the result in the
    operands' promotion, or in the accumulator dtype with ``keep_acc``
    (``precision.py:59``)."""
    out = torch.promote_types(a.dtype, b.dtype)
    acc = _acc_dtype(out)
    y = torch.matmul(a.to(acc), b.to(acc))
    return y if keep_acc else y.to(out)


def einsum_fp32acc(subscripts: str, a, b):
    """Two-operand ``torch.einsum`` with the sums in at least fp32 and the
    result in the operands' promotion (``precision.py:75``)."""
    out = torch.promote_types(a.dtype, b.dtype)
    acc = _acc_dtype(out)
    return torch.einsum(subscripts, a.to(acc), b.to(acc)).to(out)


# ------------------------------------------------------------- fp8 (O4)


def fp8_amax(x):
    """``max(|x|)`` as an fp32 scalar: the delayed-scaling observation."""
    return torch.amax(torch.abs(x.float()))


def quantize_fp8(x, scale: ScaleLike, dtype: torch.dtype = F8_E4M3):
    """Scale-in and saturating cast, ``sat(x * scale) -> dtype``, through
    the fused cast kernel."""
    y, _ = fp8_cast_kernel.cast_and_scale_stats(x, scale, dtype,
                                                _F8_MAX[dtype])
    return y


def quantize_fp8_stats(x, scale: ScaleLike, dtype: torch.dtype = F8_E4M3):
    """``(quantize_fp8(x, scale, dtype), fp8_amax(x))`` in one pass."""
    return fp8_cast_kernel.cast_and_scale_stats(x, scale, dtype,
                                                _F8_MAX[dtype])


def _product_upcast(a8, b8):
    """fp8 [..., K] @ [K, N] as fp32: the operands upcast exactly."""
    return torch.matmul(a8.float(), b8.float())


def _fp8_product(a8, b8):
    """``jnp.matmul(a8, b8, preferred_element_type=f32)`` for a 2-D
    column-major ``b8``: cuBLASLt's fp8 GEMM on the card (a row-major
    ``[M, K]`` times a column-major ``[K, N]``, K and N multiples of 16),
    an exact upcast elsewhere and for other K or N (an MLP's one-unit
    output layer)."""
    k, n = b8.shape
    if not kernel_config.on_card(a8) or k % 16 or n % 16:
        return _product_upcast(a8, b8)
    one = torch.ones((), dtype=torch.float32, device=a8.device)
    acc = torch._scaled_mm(a8.reshape(-1, k), b8, scale_a=one, scale_b=one,
                           out_dtype=torch.float32)
    return acc.reshape(*a8.shape[:-1], n)


class _MatmulFp8(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` ``_matmul_fp8``
    (``precision.py:134``): returns ``(y, amax_a, amax_b)`` and saves the
    fp8 operands, not the inputs."""

    @staticmethod
    def forward(ctx, a, b, sa, sb, gs, probe, out_dtype):
        a8, amax_a = quantize_fp8_stats(a, sa, F8_E4M3)
        # b8 column-major, as the fp8 GEMM takes it
        b8, amax_b = fp8_cast_kernel.cast_and_scale_stats(
            b, sb, F8_E4M3, F8_E4M3_MAX, col_major=True)
        y = (_fp8_product(a8, b8) * (1.0 / (sa * sb))).to(out_dtype)
        ctx.save_for_backward(a8, b8, sa, sb, gs)
        ctx.dtypes = (a.dtype, b.dtype)
        ctx.mark_non_differentiable(amax_a, amax_b)
        return y, amax_a, amax_b

    @staticmethod
    def backward(ctx, g, _g_amax_a, _g_amax_b):
        a8, b8, sa, sb, gs = ctx.saved_tensors
        a_dtype, b_dtype = ctx.dtypes
        # the fused pass gives max|g| exactly: the probe's gradient
        g8, amax_g = quantize_fp8_stats(g, gs, F8_E5M2)
        da = _product_upcast(g8, b8.t()) * (1.0 / (gs * sb))
        a2 = a8.reshape(-1, a8.shape[-1])
        g2 = g8.reshape(-1, g8.shape[-1])
        db = _product_upcast(a2.t(), g2) * (1.0 / (gs * sa))
        return (da.to(a_dtype), db.to(b_dtype), torch.zeros_like(sa),
                torch.zeros_like(sb), torch.zeros_like(gs), amax_g, None)


def _fp8_args(a, b, scale_a, scale_b, grad_scale, out_dtype, grad_probe):
    dev = a.device
    out = (out_dtype if out_dtype is not None
           else torch.promote_types(a.dtype, b.dtype))
    gs = as_scale(1.0 if grad_scale is None else grad_scale, dev)
    probe = (torch.zeros((), dtype=torch.float32, device=dev)
             if grad_probe is None else grad_probe)
    return as_scale(scale_a, dev), as_scale(scale_b, dev), gs, probe, out


def matmul_fp8(a, b, scale_a: ScaleLike, scale_b: ScaleLike, *,
               grad_scale: Optional[ScaleLike] = None,
               out_dtype: Optional[torch.dtype] = None, grad_probe=None):
    """fp8 matmul epilogue (``precision.py:172``): scale-in, saturating
    E4M3 cast, product with fp32 sums, scale-out to ``out_dtype``
    (default: the operands' promotion). ``b`` is a 2-D ``(k, n)`` weight;
    ``a`` may carry leading batch dims. The backward quantizes the
    cotangent to E5M2 under ``grad_scale``; the scales get zero
    gradients, and ``grad_probe`` (a zero fp32 scalar) gets the
    cotangent's pre-scale amax."""
    y, _, _ = matmul_fp8_stats(a, b, scale_a, scale_b,
                               grad_scale=grad_scale, out_dtype=out_dtype,
                               grad_probe=grad_probe)
    return y


def matmul_fp8_stats(a, b, scale_a: ScaleLike, scale_b: ScaleLike, *,
                     grad_scale: Optional[ScaleLike] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     grad_probe=None):
    """:func:`matmul_fp8` that also returns the operands' pre-scale
    amaxes, ``(y, amax_a, amax_b)``, from the same fused cast passes."""
    if b.dim() != 2:
        raise ValueError(
            f"matmul_fp8 expects a 2-D (k, n) weight for b, got shape "
            f"{tuple(b.shape)}: reshape leading dims into a, or use "
            f"einsum_fp8")
    sa, sb, gs, probe, out = _fp8_args(a, b, scale_a, scale_b, grad_scale,
                                       out_dtype, grad_probe)
    return _MatmulFp8.apply(a, b, sa, sb, gs, probe, out)


class _EinsumFp8(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` ``_einsum_fp8``
    (``precision.py:221``); the backward transposes the einsum through
    autograd at the saved fp8 operands, upcast to fp32 (exact)."""

    @staticmethod
    def forward(ctx, a, b, sa, sb, gs, probe, subscripts, out_dtype):
        a8 = quantize_fp8(a, sa, F8_E4M3)
        b8 = quantize_fp8(b, sb, F8_E4M3)
        acc = torch.einsum(subscripts, a8.float(), b8.float())
        ctx.save_for_backward(a8, b8, sa, sb, gs)
        ctx.subscripts = subscripts
        ctx.dtypes = (a.dtype, b.dtype)
        return (acc * (1.0 / (sa * sb))).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        a8, b8, sa, sb, gs = ctx.saved_tensors
        a_dtype, b_dtype = ctx.dtypes
        g8, amax_g = quantize_fp8_stats(g, gs, F8_E5M2)
        with torch.enable_grad():
            a32 = a8.float().requires_grad_()
            b32 = b8.float().requires_grad_()
            da, db = torch.autograd.grad(
                torch.einsum(ctx.subscripts, a32, b32), (a32, b32),
                g8.float())
        inv = 1.0 / gs
        return ((da * (inv / sb)).to(a_dtype), (db * (inv / sa)).to(b_dtype),
                torch.zeros_like(sa), torch.zeros_like(sb),
                torch.zeros_like(gs), amax_g, None, None)


def einsum_fp8(subscripts: str, a, b, scale_a: ScaleLike,
               scale_b: ScaleLike, *,
               grad_scale: Optional[ScaleLike] = None,
               out_dtype: Optional[torch.dtype] = None, grad_probe=None):
    """Two-operand einsum form of :func:`matmul_fp8`
    (``precision.py:263``)."""
    sa, sb, gs, probe, out = _fp8_args(a, b, scale_a, scale_b, grad_scale,
                                       out_dtype, grad_probe)
    return _EinsumFp8.apply(a, b, sa, sb, gs, probe, subscripts, out)


def matmul_amp(a, b, *, name: str = "matmul", keep_acc: bool = False):
    """The amp-aware contraction (``precision.py:280``).

    Outside an fp8 context it is ``torch.matmul(a, b)`` in the operands'
    dtype, the product every site ran before (on the card a bf16 product
    already sums in fp32, so the reference's ``matmul_fp32acc`` upcast
    would only turn it into an fp32 GEMM), or, with ``keep_acc``, the
    fp32 accumulator of :func:`matmul_fp32acc`. Inside the O4 context
    (``amp.scaler.current_fp8()``) a 2-D floating ``b`` goes to the
    context: a registered ``name`` (call ordinals tell repeated calls
    apart) runs :func:`matmul_fp8_stats` under its delayed scales and
    records its amaxes, any other takes the product it runs outside the
    context."""
    from apex_tpu_torch.amp.scaler import current_fp8

    ctx = current_fp8()
    if (ctx is not None and b.dim() == 2 and a.is_floating_point()
            and b.is_floating_point()):
        out = torch.promote_types(a.dtype, b.dtype)
        return ctx.matmul(a, b, name=name,
                          out_dtype=_acc_dtype(out) if keep_acc else out)
    if keep_acc:
        return matmul_fp32acc(a, b, keep_acc=True)
    return torch.matmul(a, b)
