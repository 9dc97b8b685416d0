"""Automatic mixed precision (port of ``apex_tpu.amp``, Apex's
``apex.amp``): opt levels O0–O4, dynamic loss scaling over the stateful
optimizers, O1 boundary casting and the O4 fp8 tier. See
:mod:`apex_tpu_torch.amp.frontend` for what each level does.

    opt = FusedAdam(params, lr=1e-4, flat=True)
    params, opt, handle = amp.initialize(params, opt, opt_level="O2")
"""

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp._amp_state import master_params
from apex_tpu_torch.amp.amp import (
    amp_call,
    casting,
    current_policy,
    float_function,
    half_function,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.frontend import (
    O0,
    O1,
    O2,
    O3,
    O4,
    Policy,
    Properties,
    initialize,
    load_state_dict,
    opt_levels,
    state_dict,
)
from apex_tpu_torch.amp.handle import AmpHandle, NoOpHandle
from apex_tpu_torch.amp.scaler import (
    Fp8DelayedScaler,
    Fp8ScalingState,
    Fp8SiteRecorder,
    LossScaler,
    LossScaleState,
    current_fp8,
    scaled_update,
)

__all__ = [
    "Policy", "Properties", "initialize", "state_dict", "load_state_dict",
    "O0", "O1", "O2", "O3", "O4", "opt_levels",
    "AmpHandle", "NoOpHandle", "master_params",
    "LossScaler", "LossScaleState",
    "Fp8DelayedScaler", "Fp8ScalingState", "Fp8SiteRecorder",
    "current_fp8", "scaled_update", "lists", "scale_loss",
    "amp_call", "casting", "current_policy", "half_function",
    "float_function", "promote_function", "register_half_function",
    "register_float_function", "register_promote_function",
]


def scale_loss(loss, optimizers=None):
    """Module-level ``amp.scale_loss``: the active handle's context."""
    from apex_tpu_torch.amp._amp_state import _amp_state

    if _amp_state.handle is None:
        raise RuntimeError("amp.initialize must be called before "
                           "amp.scale_loss")
    return _amp_state.handle.scale_loss(loss, optimizers)
