"""The memory tier (counterpart of ``apex_tpu.observability.memory``):

- :mod:`~apex_tpu_torch.observability.memory.hbm` -
  :class:`MemoryMonitor`: decimated live-tensor snapshots (a ``gc`` walk
  of the tensors on the card, each storage once, beside the CUDA
  allocator's counters), the watermark
  (``torch.cuda.max_memory_allocated``), top-k largest buffers, the
  ``memory/*`` gauge family, and identity-stamped ``rank_path``-suffixed
  dumps;
- :mod:`~apex_tpu_torch.observability.memory.compiled` - the per-graph
  memory of every captured CUDA graph (the reference's per-executable
  view): the bytes its private pool holds, its static inputs and
  outputs, the ``memory/compiled_total_bytes{fn=}`` gauges, and the
  ``compiled`` table of :meth:`MemoryMonitor.dump`;
- :mod:`~apex_tpu_torch.observability.memory.oom` - OOM forensics:
  ``torch.OutOfMemoryError`` classification, the parse of PyTorch's
  message, the ``memrec_*.json`` post-mortem artifact, and the verdict
  :class:`~apex_tpu_torch.resilience.ResilientTrainLoop` attaches to
  ``rollback`` events and ``TrainAborted.report["memory"]``.

The reference's measured-vs-modeled calibration (``calibrate``) comes
with a later slice (ROADMAP.md, Queue 1 item 8).
"""

from apex_tpu_torch.observability.memory.compiled import (
    COMPILED_STAT_FIELDS,
    CompiledMemoryCapture,
    captured_graph_fields,
    current_capture,
    install_compiled_capture,
    memory_analysis_fields,
    uninstall_compiled_capture,
)
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
    "CompiledMemoryCapture", "install_compiled_capture",
    "uninstall_compiled_capture", "current_capture",
    "memory_analysis_fields", "captured_graph_fields",
    "COMPILED_STAT_FIELDS",
    "OOM_MARKERS", "is_oom_error", "parse_resource_exhausted",
    "dump_memrec", "oom_forensics",
]
