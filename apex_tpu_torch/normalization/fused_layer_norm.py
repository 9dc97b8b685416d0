"""Fused LayerNorm and RMSNorm (port of
``apex_tpu/normalization/fused_layer_norm.py``).

Two API layers, as in the reference:

- functional: ``fused_layer_norm[_affine]``, ``fused_rms_norm[_affine]``,
  the ``mixed_dtype_*`` variants and the unfused ``manual_rms_norm``;
- modules: :class:`FusedLayerNorm` and :class:`FusedRMSNorm`
  (``torch.nn.Module``s holding ``weight`` / ``bias`` parameters) and the
  Megatron-style :class:`MixedFusedLayerNorm` / :class:`MixedFusedRMSNorm`,
  which keep fp32 affine params under bf16 activations.

The compute path is ``apex_tpu_torch.ops.layer_norm.layer_norm`` and
``.rms_norm``: the CUDA kernels for CUDA tensors, the plain PyTorch
versions for CPU tensors, differentiable in the input and the affine
params (fp32 statistics whatever the input dtype).
"""

from __future__ import annotations

import numbers
from typing import Sequence, Union

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.ops import layer_norm as _ops

Shape = Union[int, Sequence[int]]


def _canon(normalized_shape: Shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:168."""
    return _ops.layer_norm(input, weight, bias, _canon(normalized_shape), eps)


def fused_layer_norm(input, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:174."""
    return _ops.layer_norm(input, None, None, _canon(normalized_shape), eps)


def mixed_dtype_fused_layer_norm_affine(input, weight, bias, normalized_shape,
                                        eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:180: bf16 input, fp32
    affine (the kernel takes the param dtype apart from x's)."""
    return _ops.layer_norm(input, weight, bias, _canon(normalized_shape), eps)


def fused_rms_norm_affine(input, weight, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:186."""
    return _ops.rms_norm(input, weight, _canon(normalized_shape), eps)


def fused_rms_norm(input, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:192."""
    return _ops.rms_norm(input, None, _canon(normalized_shape), eps)


def mixed_dtype_fused_rms_norm_affine(input, weight, normalized_shape,
                                      eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:198."""
    return _ops.rms_norm(input, weight, _canon(normalized_shape), eps)


def manual_rms_norm(input, normalized_shape, weight, eps):
    """The unfused path (``fused_layer_norm.py:70``): fp32 mean of
    squares over the normalized dims, the result in the input's dtype,
    then times ``weight``."""
    dims = tuple(range(-len(_canon(normalized_shape)), 0))
    x = input.float()
    variance = torch.mean(torch.square(x), dim=dims, keepdim=True)
    out = (x * (1.0 / torch.sqrt(variance + eps))).to(input.dtype)
    if weight is not None:
        out = weight * out
    return out


class FusedLayerNorm(torch.nn.Module):
    """LayerNorm module over the fused kernel (``fused_layer_norm.py:
    83``): ``weight`` ones and ``bias`` zeros of ``normalized_shape`` in
    ``param_dtype`` on ``device`` (default: the GPU, raising when there
    is none). ``memory_efficient`` is accepted for the reference's
    signature: the backward already recomputes from (mu, rstd)."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 device: _device.DeviceLike = None):
        super().__init__()
        self.normalized_shape = _canon(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            device = _device.resolve(device)
            self.weight = torch.nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
            self.bias = torch.nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))

    def forward(self, x):
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.weight, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)


class FusedRMSNorm(torch.nn.Module):
    """RMSNorm module over the fused kernel (``fused_layer_norm.py:
    108``): ``weight`` ones of ``normalized_shape`` in ``param_dtype``."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 device: _device.DeviceLike = None):
        super().__init__()
        self.normalized_shape = _canon(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            self.weight = torch.nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype,
                device=_device.resolve(device)))

    def forward(self, x):
        if self.elementwise_affine:
            return fused_rms_norm_affine(x, self.weight,
                                         self.normalized_shape, self.eps)
        return fused_rms_norm(x, self.normalized_shape, self.eps)


class MixedFusedLayerNorm(FusedLayerNorm):
    """Megatron variant (``fused_layer_norm.py:126``): fp32 affine params
    under low-precision activations; the kernel takes the param dtype
    apart from the input's."""


class MixedFusedRMSNorm(FusedRMSNorm):
    """``fused_layer_norm.py:134``."""
