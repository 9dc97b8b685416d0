"""Functional fused RMSNorm (port of
``apex_tpu/normalization/fused_layer_norm.py``).

The compute path is ``apex_tpu_torch.ops.layer_norm.rms_norm``: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors.
LayerNorm and the module classes come with the GPT-2/BERT slice.
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


def fused_rms_norm_affine(input, weight, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:186."""
    return _ops.rms_norm(input, weight, _canon(normalized_shape), eps)


def fused_rms_norm(input, normalized_shape, eps=1e-6):
    """Ref apex/normalization/fused_layer_norm.py:192."""
    return _ops.rms_norm(input, None, _canon(normalized_shape), eps)
