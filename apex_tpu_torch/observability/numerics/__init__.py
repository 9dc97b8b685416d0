"""The numerics tier (counterpart of ``apex_tpu.observability.numerics``):

- :mod:`~apex_tpu_torch.observability.numerics.stats` - amax / l2 /
  underflow-fraction / zero-fraction / finite-flag for a whole tree,
  one host fetch a pass, pulled on the :class:`StatsCollector`'s
  decimated cadence;
- :mod:`~apex_tpu_torch.observability.numerics.history` -
  :class:`AmaxHistory` rings, the fp8 delayed-scaling primitive;
- :mod:`~apex_tpu_torch.observability.numerics.health` -
  :class:`HealthMonitor`: grad-norm-spike, loss-plateau/spike and
  scaler-overflow-streak detectors emitting the ``numerics/*`` family.

The reference's NaN provenance probe (``nan_probe``, a jaxpr replay
under its analysis interpreter) comes with the analysis slice
(ROADMAP.md, Queue 1 item 8).
"""

from apex_tpu_torch.observability.numerics.health import HealthMonitor
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
    "HealthMonitor",
]
