"""Multi-tensor ops (counterpart of ``apex_tpu.multi_tensor_apply``): the
global L2 norm that FusedLAMB needs, so far."""

from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (  # noqa: F401
    multi_tensor_l2norm,
)
