"""Numerics for the port: the amax history rings of fp8 delayed scaling
(counterpart of ``apex_tpu.observability.numerics``, ``history`` only)."""

from apex_tpu_torch.observability.numerics.history import (
    F8_E4M3_MAX,
    F8_E5M2_MAX,
    AmaxHistory,
    AmaxHistoryState,
)

__all__ = ["F8_E4M3_MAX", "F8_E5M2_MAX", "AmaxHistory", "AmaxHistoryState"]
