"""FastLayerNorm (port of ``apex_tpu/contrib/layer_norm.py``; ref
apex/contrib/layer_norm/layer_norm.py and its ``ln_fwd``/``ln_bwd``
kernels).

The contrib names over the port's fused LayerNorm: the forward and
backward run the LayerNorm kernels (``csrc/layer_norm.cu``) on a CUDA
tensor and their plain versions on a CPU tensor.
"""

from __future__ import annotations

from apex_tpu_torch import _device
from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    fused_layer_norm_affine,
)


def fast_layer_norm(x, gamma, beta, epsilon: float = 1e-5):
    """LayerNorm over the last dim with ``gamma`` and ``beta`` (ref
    ``FastLayerNormFN.apply``)."""
    return fused_layer_norm_affine(x, gamma, beta, (x.shape[-1],),
                                   eps=epsilon)


class FastLayerNorm(FusedLayerNorm):
    """ref ``layer_norm.py:20``: normalised over the last dim of
    ``hidden_size``, always affine; ``weight`` and ``bias`` fp32 on
    ``device`` (default: the GPU, raising when there is none)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-5,
                 device: _device.DeviceLike = None):
        super().__init__((hidden_size,), eps=epsilon, device=device)
