"""The contrib ``FusedLAMB`` (port of
``apex_tpu/contrib/optimizers/fused_lamb.py``): the main one."""

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, fused_lamb

__all__ = ["FusedLAMB", "fused_lamb"]
