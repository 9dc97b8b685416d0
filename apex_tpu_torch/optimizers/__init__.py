"""Fused optimizers (counterpart of ``apex_tpu.optimizers``).

Each optimizer exists as a functional transform (``fused_adam(...)``,
``init`` / ``update``) and as an Apex-style stateful class
(``FusedAdam(params, ...)``, ``step(grads)``) over it. ``fused_adam`` /
``FusedAdam``, ``fused_sgd`` / ``FusedSGD`` and ``fused_lamb`` /
``FusedLAMB`` are ported; ``fused_novograd``, ``fused_adagrad`` and
``fused_mixed_precision_lamb`` are not yet: each raises
``NotImplementedError``.
"""

from apex_tpu_torch.optimizers._base import (  # noqa: F401
    FusedOptimizer,
    opt_partition_specs,
)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
    FusedAdamState,
    GradientTransformation,
    fused_adam,
    opt_state_from_numpy,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
    fused_sgd,
)


def _not_ported(name: str):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: it waits for the port of "
            f"apex_tpu/optimizers/ beyond FusedAdam, FusedSGD and "
            f"FusedLAMB (ROADMAP.md, Queue 1 item 6.3)")

    raise_not_ported.__name__ = name
    return raise_not_ported


fused_novograd = _not_ported("fused_novograd")
FusedNovoGrad = _not_ported("FusedNovoGrad")
fused_adagrad = _not_ported("fused_adagrad")
FusedAdagrad = _not_ported("FusedAdagrad")
fused_mixed_precision_lamb = _not_ported("fused_mixed_precision_lamb")
FusedMixedPrecisionLamb = _not_ported("FusedMixedPrecisionLamb")

__all__ = [
    "FusedOptimizer", "opt_partition_specs",
    "FusedAdam", "FusedAdamState", "fused_adam", "opt_state_from_numpy",
    "FusedLAMB", "FusedLAMBState", "fused_lamb", "GradientTransformation",
    "FusedSGD", "FusedSGDState", "fused_sgd",
]
