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
- :mod:`~apex_tpu_torch.observability.memory` - live-tensor snapshots,
  the CUDA allocator's watermark, OOM forensics (``memrec_*.json``);
- :mod:`~apex_tpu_torch.observability.fleet` - rank identity and the
  automatic ``.rank{i}`` artifact suffix;
- :mod:`~apex_tpu_torch.observability.goodput` - the run ledger and
  goodput accounting, with the ``goodput/*`` gauge family; event names
  are pinned by the :mod:`~apex_tpu_torch.observability.events` catalog;
- ``python -m apex_tpu_torch.observability report|trace|memory|goodput``
  - the CLI.

Not ported yet (ROADMAP.md, Queue 1 items 7 and 8): the recompile
listener, the compiled-memory capture and calibration, the device
trace attribution, the NaN probe, and the fleet's straggler and desync
detectors and merge readers.
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
from apex_tpu_torch.observability.memory import MemoryMonitor
from apex_tpu_torch.observability import fleet
from apex_tpu_torch.observability.fleet import process_identity, rank_path
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
    "scope", "annotate",
    "span", "SpanTracer", "get_tracer", "set_tracer",
    "StepPhases", "FlightRecorder",
    "StepReporter", "STEP_RECORD_FIELDS", "peak_flops",
    "transformer_step_flops",
    "numerics", "StatsCollector", "AmaxHistory", "HealthMonitor",
    "memory", "MemoryMonitor",
    "fleet", "process_identity", "rank_path",
    "goodput", "RunLedger", "ledger_from_records", "account_goodput",
    "EVENT_CATALOG", "GOODPUT_CRITICAL",
]
