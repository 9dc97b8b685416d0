"""Fused optimizers (counterpart of ``apex_tpu.optimizers``).

Each optimizer exists as a functional transform (``fused_adam(...)``,
``init`` / ``update``) and as an Apex-style stateful class
(``FusedAdam(params, ...)``, ``step(grads)``) over it. ``fused_adam`` /
``FusedAdam``, ``fused_sgd`` / ``FusedSGD`` and ``fused_lamb`` /
``FusedLAMB``, ``fused_adagrad`` / ``FusedAdagrad``, ``fused_novograd``
/ ``FusedNovoGrad`` and ``fused_mixed_precision_lamb`` /
``FusedMixedPrecisionLamb`` (fp32 masters in its state).
``opt_state_from_numpy`` carries any of their JAX states across.
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
from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    FusedAdagrad,
    FusedAdagradState,
    fused_adagrad,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (  # noqa: F401
    FusedMixedPrecisionLamb,
    FusedMPLambState,
    fused_mixed_precision_lamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
    FusedNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
    fused_sgd,
)


__all__ = [
    "FusedOptimizer", "opt_partition_specs",
    "FusedAdam", "FusedAdamState", "fused_adam", "opt_state_from_numpy",
    "FusedLAMB", "FusedLAMBState", "fused_lamb", "GradientTransformation",
    "FusedSGD", "FusedSGDState", "fused_sgd",
    "FusedAdagrad", "FusedAdagradState", "fused_adagrad",
    "FusedNovoGrad", "FusedNovoGradState", "fused_novograd",
    "FusedMixedPrecisionLamb", "FusedMPLambState",
    "fused_mixed_precision_lamb",
]
