"""Fused dense layers (port of ``apex_tpu/fused_dense.py``, Apex's
``apex.fused_dense``).

Apex fuses gemm + bias (and gemm + bias + GeLU + gemm + bias) in
cuBLASLt epilogues; the JAX package writes them as plain expressions for
XLA to fuse, and so does the port: the products are ``torch.matmul`` (or
the fp8 product of ``ops.precision`` under O4), outside any Pallas
kernel in the reference. The forward products go through the amp hook
:func:`~apex_tpu_torch.ops.precision.matmul_amp` at site
``"fused_dense"``.

:func:`fused_dense_gelu_dense_function` saves ``gelu_in`` and
``output1`` for its backward, as the reference's ``_fdgd_fwd`` /
``_fdgd_bwd`` do (``fused_dense.py:66-86``), with the exact (erf) GeLU
and the weight gradients summed in fp32 (``_wgrad``, ``:25``). Under the
O4 fp8 context it steps aside and autograd takes the fp8 products' own
backward (``:53``). The three functions are amp half functions: under O1
their inputs are cast to the compute dtype (``:92-96``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.amp.amp import half_function
from apex_tpu_torch.ops.precision import (
    einsum_fp32acc,
    matmul_amp,
    matmul_fp32acc,
)


def _mm(a, b):
    return matmul_amp(a, b, name="fused_dense")


def _wgrad(x, g):
    """``sum over rows of x^T g`` with fp32 sums (``fused_dense.py:25``)."""
    return einsum_fp32acc("...i,...o->io", x, g)


def _rows_sum(g):
    return torch.sum(g, dim=tuple(range(g.dim() - 1)))


def _gelu(t):
    return F.gelu(t, approximate="none")


def fused_dense_function(input, weight, bias):
    """gemm + bias; ``weight`` is ``(in, out)`` (``FusedDenseFunc``)."""
    return _mm(input, weight) + bias


def dense_no_bias_function(input, weight):
    return _mm(input, weight)


def _fdgd_forward(input, weight1, bias1, weight2, bias2):
    gelu_in = _mm(input, weight1) + bias1
    output1 = _gelu(gelu_in)
    return _mm(output1, weight2) + bias2, gelu_in, output1


class _FusedDenseGeluDense(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_fdgd_vjp``
    (``fused_dense.py:46``)."""

    @staticmethod
    def forward(ctx, input, weight1, bias1, weight2, bias2):
        output2, gelu_in, output1 = _fdgd_forward(input, weight1, bias1,
                                                  weight2, bias2)
        ctx.save_for_backward(input, weight1, weight2, gelu_in, output1)
        return output2

    @staticmethod
    def backward(ctx, g):
        input, weight1, weight2, gelu_in, output1 = ctx.saved_tensors
        # second gemm
        d_output1 = matmul_fp32acc(g, weight2.t())
        d_weight2 = _wgrad(output1, g)
        d_bias2 = _rows_sum(g)
        # GeLU (exact erf form)
        with torch.enable_grad():
            t = gelu_in.detach().requires_grad_()
            d_gelu_in, = torch.autograd.grad(_gelu(t), t, d_output1)
        # first gemm
        d_input = matmul_fp32acc(d_gelu_in, weight1.t())
        d_weight1 = _wgrad(input, d_gelu_in)
        d_bias1 = _rows_sum(d_gelu_in)
        return d_input, d_weight1, d_bias1, d_weight2, d_bias2


def fused_dense_gelu_dense_function(input, weight1, bias1, weight2, bias2):
    """dense -> GeLU -> dense (``FusedDenseGeluDenseFunc``)."""
    from apex_tpu_torch.amp.scaler import current_fp8

    if current_fp8() is not None:
        return _fdgd_forward(input, weight1, bias1, weight2, bias2)[0]
    return _FusedDenseGeluDense.apply(input, weight1, bias1, weight2, bias2)


# O1 boundary casts: the gemm (+ GeLU) chains run in the compute dtype
fused_dense_function = half_function(fused_dense_function)
dense_no_bias_function = half_function(dense_no_bias_function)
fused_dense_gelu_dense_function = half_function(
    fused_dense_gelu_dense_function)


def _uniform(gen, shape, bound, dtype, device):
    return (torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * (2 * bound) - bound).to(dtype)


class FusedDense:
    """Apex-shaped module (``fused_dense.py:66``). Weights are stored
    ``(in, out)``; ``.params`` is the optimizer-ready tree, drawn uniform
    in ``+-1/sqrt(in_features)`` from a generator seeded with ``seed``
    on ``device`` (default: the GPU, raising when there is none)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: _device.DeviceLike = None):
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        device = _device.resolve(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        bound = in_features ** -0.5
        self.params = {"weight": _uniform(gen, (in_features, out_features),
                                          bound, dtype, device)}
        if bias:
            self.params["bias"] = _uniform(gen, (out_features,), bound,
                                           dtype, device)

    def __call__(self, x, params=None):
        p = params if params is not None else self.params
        if self.use_bias:
            return fused_dense_function(x, p["weight"], p["bias"])
        return dense_no_bias_function(x, p["weight"])


class FusedDenseGeluDense:
    """``fused_dense.py:84``: dense -> GeLU -> dense, both with bias."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: _device.DeviceLike = None):
        if not bias:
            raise ValueError("FusedDenseGeluDense requires bias=True "
                             "(fused_dense.py:88)")
        device = _device.resolve(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        b1, b2 = in_features ** -0.5, intermediate_features ** -0.5
        shapes = (("weight1", (in_features, intermediate_features), b1),
                  ("bias1", (intermediate_features,), b1),
                  ("weight2", (intermediate_features, out_features), b2),
                  ("bias2", (out_features,), b2))
        self.params = {name: _uniform(gen, shape, bound, dtype, device)
                       for name, shape, bound in shapes}

    def __call__(self, x, params=None):
        p = params if params is not None else self.params
        return fused_dense_gelu_dense_function(
            x, p["weight1"], p["bias1"], p["weight2"], p["bias2"])
