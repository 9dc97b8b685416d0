"""The memory tier (counterpart of ``apex_tpu.observability.memory``):

- :mod:`~apex_tpu_torch.observability.memory.hbm` -
  :class:`MemoryMonitor`: decimated live-tensor snapshots (a ``gc`` walk
  of the tensors on the card, each storage once, beside the CUDA
  allocator's counters), the watermark
  (``torch.cuda.max_memory_allocated``), top-k largest buffers, the
  ``memory/*`` gauge family, and identity-stamped ``rank_path``-suffixed
  dumps;
- :mod:`~apex_tpu_torch.observability.memory.oom` - OOM forensics:
  ``torch.OutOfMemoryError`` classification, the parse of PyTorch's
  message, the ``memrec_*.json`` post-mortem artifact, and the verdict
  :class:`~apex_tpu_torch.resilience.ResilientTrainLoop` attaches to
  ``rollback`` events and ``TrainAborted.report["memory"]``.

The reference's per-executable compiled-memory capture and its
measured-vs-modeled calibration (``compiled``, ``calibrate``) come with
later slices (ROADMAP.md, Queue 1 items 7 and 8).
"""

from apex_tpu_torch.observability.memory.hbm import (
    MEMORY_SCHEMA_VERSION,
    MEMORY_STATS_FIELDS,
    MemoryMonitor,
    active_monitor,
    device_live_bytes,
    device_memory_stats,
    flight_section,
    live_buffer_records,
    memory_snapshot,
    set_active_monitor,
)
from apex_tpu_torch.observability.memory.oom import (
    OOM_MARKERS,
    dump_memrec,
    is_oom_error,
    oom_forensics,
    parse_resource_exhausted,
)

__all__ = [
    "MEMORY_SCHEMA_VERSION", "MEMORY_STATS_FIELDS", "MemoryMonitor",
    "memory_snapshot", "live_buffer_records", "device_live_bytes",
    "device_memory_stats", "active_monitor", "set_active_monitor",
    "flight_section",
    "OOM_MARKERS", "is_oom_error", "parse_resource_exhausted",
    "dump_memrec", "oom_forensics",
]
