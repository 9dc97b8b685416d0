"""Span tracing, per-step phase attribution and the stall flight
recorder (counterpart of ``apex_tpu.observability.profiling``):

- :mod:`~apex_tpu_torch.observability.profiling.spans` - always-on
  ring-buffer span tracer; ``span()`` names every hot path and exports
  Chrome/Perfetto trace-event JSON;
- :mod:`~apex_tpu_torch.observability.profiling.step_phases` - the
  StepReporter phase breakdown (host/data/compute/comms + overlap
  efficiency);
- :mod:`~apex_tpu_torch.observability.profiling.flight_recorder` -
  stall watchdog + SIGQUIT post-mortem dumps.

CLI: ``python -m apex_tpu_torch.observability trace <dump>`` exports a
span dump or flight record as Perfetto-loadable JSON. The device-side
attribution from a profiler capture (the reference's ``xplane``) comes
with the ``pyprof`` slice (ROADMAP.md, Queue 1 item 7).
"""

from apex_tpu_torch.observability.profiling.flight_recorder import (
    FlightRecorder,
)
from apex_tpu_torch.observability.profiling.spans import (
    Span,
    SpanTracer,
    decode_span_payload,
    get_tracer,
    load_spans,
    set_tracer,
    span,
    spans_from_dicts,
    to_trace_events,
    write_chrome_trace,
)
from apex_tpu_torch.observability.profiling.step_phases import (
    StepPhases,
    classify_span,
    compute_breakdown,
    device_phase_fields,
)

__all__ = [
    "Span", "SpanTracer", "span", "get_tracer", "set_tracer",
    "to_trace_events", "write_chrome_trace", "load_spans",
    "decode_span_payload", "spans_from_dicts",
    "StepPhases", "classify_span", "compute_breakdown",
    "device_phase_fields",
    "FlightRecorder",
]
