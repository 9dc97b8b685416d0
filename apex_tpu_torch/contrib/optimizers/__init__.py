"""``apex.contrib.optimizers`` (counterpart of
``apex_tpu.contrib.optimizers``): the contrib ``FP16_Optimizer``
(dynamic loss scale on by default), the legacy ``FusedAdam``,
``FusedLAMB`` and ``FusedSGD`` over the main optimizers, and the
ZeRO-sharded ``DistributedFusedAdam`` (its step on the flat Adam kernel, one launch a
dtype bucket a rank) and ``DistributedFusedLAMB``.
"""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    dist_adam_partition_specs,
    distributed_fused_adam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
    distributed_fused_lamb,
)
from apex_tpu_torch.contrib.optimizers.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.contrib.optimizers.fused_adam import FusedAdam, fused_adam
from apex_tpu_torch.contrib.optimizers.fused_lamb import FusedLAMB, fused_lamb
from apex_tpu_torch.contrib.optimizers.fused_sgd import FusedSGD, fused_sgd

__all__ = [
    "DistributedFusedAdam", "distributed_fused_adam",
    "dist_adam_partition_specs",
    "DistributedFusedLAMB", "distributed_fused_lamb",
    "FP16_Optimizer", "FusedAdam", "fused_adam", "FusedLAMB", "fused_lamb",
    "FusedSGD", "fused_sgd",
]
