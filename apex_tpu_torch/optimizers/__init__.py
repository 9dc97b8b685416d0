"""Fused optimizers (counterpart of ``apex_tpu.optimizers``)."""

from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdamState,
    GradientTransformation,
    fused_adam,
    opt_state_from_numpy,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMBState,
    fused_lamb,
)
