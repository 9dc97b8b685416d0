"""DistributedFusedAdam v2 (port of
``apex_tpu/contrib/optimizers/distributed_fused_adam_v2.py``).

The reference's v2 and v3 differ from v1 only in how NCCL overlaps the
reduction (its ``dwu_*`` pipelining knobs); the JAX package shares one
implementation, and so does the port. The names exist for import
parity.
"""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    distributed_fused_adam,
)

DistributedFusedAdamV2 = DistributedFusedAdam

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamV2",
           "distributed_fused_adam"]
