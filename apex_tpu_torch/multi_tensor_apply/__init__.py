"""Multi-tensor ops (counterpart of ``apex_tpu.multi_tensor_apply``):
scale, axpby and the L2 norms, each returning its overflow flag, and
the ``multi_tensor_applier`` shim."""

from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (  # noqa: F401
    MultiTensorApply,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_l2norm_mp,
    multi_tensor_l2norm_scale,
    multi_tensor_scale,
)

__all__ = ["MultiTensorApply", "multi_tensor_applier", "multi_tensor_scale",
           "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_l2norm_mp", "multi_tensor_l2norm_scale"]
