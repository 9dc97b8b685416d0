"""``apex.contrib.optimizers`` (counterpart of
``apex_tpu.contrib.optimizers``): the contrib ``FP16_Optimizer``
(dynamic loss scale on by default), and the legacy ``FusedAdam``,
``FusedLAMB`` and ``FusedSGD`` over the main optimizers. The
distributed optimizers wait for ROADMAP.md Queue 1 item 6.7 and raise.
"""

from apex_tpu_torch.contrib.optimizers.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.contrib.optimizers.fused_adam import FusedAdam, fused_adam
from apex_tpu_torch.contrib.optimizers.fused_lamb import FusedLAMB, fused_lamb
from apex_tpu_torch.contrib.optimizers.fused_sgd import FusedSGD, fused_sgd


def _not_ported(name: str):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: it waits for the rest of contrib/ "
            f"(ROADMAP.md, Queue 1 item 6.7)")

    raise_not_ported.__name__ = name
    return raise_not_ported


DistributedFusedAdam = _not_ported("DistributedFusedAdam")
distributed_fused_adam = _not_ported("distributed_fused_adam")
DistributedFusedLAMB = _not_ported("DistributedFusedLAMB")
distributed_fused_lamb = _not_ported("distributed_fused_lamb")

__all__ = [
    "DistributedFusedAdam", "distributed_fused_adam",
    "DistributedFusedLAMB", "distributed_fused_lamb",
    "FP16_Optimizer", "FusedAdam", "fused_adam", "FusedLAMB", "fused_lamb",
    "FusedSGD", "fused_sgd",
]
