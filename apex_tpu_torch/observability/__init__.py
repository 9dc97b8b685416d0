"""Runtime telemetry for the port (counterpart of
``apex_tpu.observability``): the layer a training run reports through.

- :mod:`~apex_tpu_torch.observability.registry` - thread-safe metrics
  (counter/gauge/histogram/synced timer), structured events, JSONL
  export and the merge/summary reader, in the reference's record format;
- :mod:`~apex_tpu_torch.observability.scope` - named scopes on the
  ``torch.profiler`` host timeline and, once CUDA is up, NVTX ranges;
- :mod:`~apex_tpu_torch.observability.step_report` - per-training-step
  records (step time, tokens/s, MFU against the card's peak, loss
  scale, overflow count);
- :mod:`~apex_tpu_torch.observability.profiling` - span tracing (ring
  buffer + Perfetto export), per-step phase attribution, and the stall
  flight recorder;
- :mod:`~apex_tpu_torch.observability.numerics` - tensor stats (one
  host fetch a pass, decimated), amax history rings, training-health
  detectors;
- :mod:`~apex_tpu_torch.observability.recompile` - the compile
  listener (CUDA-graph captures and ``torch._dynamo`` compiles) and
  ``retrace_guard``;
- :mod:`~apex_tpu_torch.observability.memory` - live-tensor snapshots,
  the CUDA allocator's watermark, the captured graphs' memory, OOM
  forensics (``memrec_*.json``);
- :mod:`~apex_tpu_torch.observability.fleet` - rank identity and the
  automatic ``.rank{i}`` artifact suffix, the grad-sync wait probe and
  straggler detector, desync fingerprints, and the fleet merge readers;
- :mod:`~apex_tpu_torch.observability.goodput` - the run ledger and
  goodput accounting, with the ``goodput/*`` gauge family; event names
  are pinned by the :mod:`~apex_tpu_torch.observability.events` catalog;
- ``python -m apex_tpu_torch.observability
  report|trace|fleet|memory|goodput`` - the CLI.

The device trace attribution (``profiling.xplane``) reads
``torch.profiler`` traces (:mod:`apex_tpu_torch.pyprof`). Not ported
yet (ROADMAP.md, Queue 1 item 8): the memory calibration and the NaN
probe.
"""

from apex_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    Timer,
    append_event,
    get_registry,
    read_jsonl,
    set_registry,
    summarize,
)
from apex_tpu_torch.observability.recompile import (
    RecompileListener,
    RetraceBudgetExceeded,
    retrace_guard,
)
from apex_tpu_torch.observability.recompile import (
    install as install_recompile_listener,
)
from apex_tpu_torch.observability.recompile import (
    uninstall as uninstall_recompile_listener,
)
from apex_tpu_torch.observability.profiling import (
    FlightRecorder,
    SpanTracer,
    StepPhases,
    get_tracer,
    set_tracer,
    span,
)
from apex_tpu_torch.observability import numerics
from apex_tpu_torch.observability.numerics import (
    AmaxHistory,
    HealthMonitor,
    StatsCollector,
)
from apex_tpu_torch.observability import memory
from apex_tpu_torch.observability.memory import (
    CompiledMemoryCapture,
    MemoryMonitor,
    install_compiled_capture,
)
from apex_tpu_torch.observability import fleet
from apex_tpu_torch.observability.fleet import (
    DesyncDetector,
    StragglerDetector,
    merge_fleet,
    merge_flight_records,
    process_identity,
    rank_path,
)
from apex_tpu_torch.observability import goodput
from apex_tpu_torch.observability.goodput import (
    RunLedger,
    ledger_from_records,
)
from apex_tpu_torch.observability.goodput import account as account_goodput
from apex_tpu_torch.observability.events import (
    EVENT_CATALOG,
    GOODPUT_CRITICAL,
)
from apex_tpu_torch.observability.scope import annotate, scope
from apex_tpu_torch.observability.step_report import (
    STEP_RECORD_FIELDS,
    StepReporter,
    peak_flops,
    transformer_step_flops,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricRegistry",
    "get_registry", "set_registry", "read_jsonl", "summarize",
    "append_event",
    "RecompileListener", "RetraceBudgetExceeded", "retrace_guard",
    "install_recompile_listener", "uninstall_recompile_listener",
    "scope", "annotate",
    "span", "SpanTracer", "get_tracer", "set_tracer",
    "StepPhases", "FlightRecorder",
    "StepReporter", "STEP_RECORD_FIELDS", "peak_flops",
    "transformer_step_flops",
    "numerics", "StatsCollector", "AmaxHistory", "HealthMonitor",
    "memory", "MemoryMonitor", "CompiledMemoryCapture",
    "install_compiled_capture",
    "fleet", "DesyncDetector", "StragglerDetector", "merge_fleet",
    "merge_flight_records", "process_identity", "rank_path",
    "goodput", "RunLedger", "ledger_from_records", "account_goodput",
    "EVENT_CATALOG", "GOODPUT_CRITICAL",
]
