"""Functional transformer ops (counterpart of
``apex_tpu.transformer.functional``)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = [
    "FusedScaleMaskSoftmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
]
