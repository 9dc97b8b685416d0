"""Functional fused LayerNorm and RMSNorm (port of
``apex_tpu/normalization/fused_layer_norm.py``).

The compute path is ``apex_tpu_torch.ops.layer_norm.layer_norm`` and
``.rms_norm``: the CUDA kernels for CUDA tensors, the plain PyTorch
versions for CPU tensors, differentiable in the input and the affine
params. The module classes (``FusedLayerNorm``, ``FusedRMSNorm`` and
the mixed-dtype ones) are not ported yet.
"""

from __future__ import annotations

import numbers
from typing import Sequence, Union

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
