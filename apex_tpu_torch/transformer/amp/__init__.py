"""The pipeline-parallel ``GradScaler`` (counterpart of
``apex_tpu.transformer.amp``)."""

from apex_tpu_torch.transformer.amp.grad_scaler import GradScaler

__all__ = ["GradScaler"]
