"""DistributedFusedAdam v3 (port of
``apex_tpu/contrib/optimizers/distributed_fused_adam_v3.py``): v1 under
another name, as in ``distributed_fused_adam_v2``."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    distributed_fused_adam,
)

DistributedFusedAdamV3 = DistributedFusedAdam

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamV3",
           "distributed_fused_adam"]
