"""The numerics tier (counterpart of ``apex_tpu.observability.numerics``):

- :mod:`~apex_tpu_torch.observability.numerics.stats` - amax / l2 /
  underflow-fraction / zero-fraction / finite-flag for a whole tree,
  one host fetch a pass, pulled on the :class:`StatsCollector`'s
  decimated cadence;
- :mod:`~apex_tpu_torch.observability.numerics.history` -
  :class:`AmaxHistory` rings, the fp8 delayed-scaling primitive;
- :mod:`~apex_tpu_torch.observability.numerics.health` -
  :class:`HealthMonitor`: grad-norm-spike, loss-plateau/spike and
  scaler-overflow-streak detectors emitting the ``numerics/*`` family;
- :mod:`~apex_tpu_torch.observability.numerics.nan_probe` - NaN/Inf
  provenance: the first op or hand-written kernel that made or consumed
  a non-finite value, from an eager replay under a ``TorchDispatchMode``
  (the reference replays a jaxpr under its analysis interpreter).
"""

from apex_tpu_torch.observability.numerics.health import HealthMonitor
from apex_tpu_torch.observability.numerics.nan_probe import (
    Provenance,
    probe_fn,
    probe_tree,
    step_provenance,
)
from apex_tpu_torch.observability.numerics.history import (
    F8_E4M3_MAX,
    F8_E5M2_MAX,
    AmaxHistory,
    AmaxHistoryState,
)
from apex_tpu_torch.observability.numerics.stats import (
    TENSOR_STAT_FIELDS,
    StatsCollector,
    TreeStats,
    host_tensor_stats,
    leaf_paths,
    nonfinite_paths,
    summarize_stats,
    tensor_stats,
    tree_paths,
)

__all__ = [
    "TENSOR_STAT_FIELDS", "TreeStats", "tensor_stats",
    "host_tensor_stats", "leaf_paths", "tree_paths",
    "nonfinite_paths", "summarize_stats", "StatsCollector",
    "AmaxHistory", "AmaxHistoryState", "F8_E4M3_MAX", "F8_E5M2_MAX",
    "HealthMonitor", "Provenance", "probe_fn", "probe_tree",
    "step_provenance",
]
