"""Span tracing, per-step phase attribution and the stall flight
recorder (counterpart of ``apex_tpu.observability.profiling``):

- :mod:`~apex_tpu_torch.observability.profiling.spans` - always-on
  ring-buffer span tracer; ``span()`` names every hot path and exports
  Chrome/Perfetto trace-event JSON;
- :mod:`~apex_tpu_torch.observability.profiling.xplane` - device-side
  per-phase attribution from a ``torch.profiler`` trace (the module
  keeps the reference's name);
- :mod:`~apex_tpu_torch.observability.profiling.step_phases` - the
  StepReporter phase breakdown (host/data/compute/comms + overlap
  efficiency), with the device's fields from an attribution;
- :mod:`~apex_tpu_torch.observability.profiling.flight_recorder` -
  stall watchdog + SIGQUIT post-mortem dumps.

CLI: ``python -m apex_tpu_torch.observability trace <run>`` exports a
span dump, a flight record or a ``torch.profiler`` trace as
Perfetto-loadable JSON.
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
from apex_tpu_torch.observability.profiling.xplane import (
    PHASES,
    DeviceAttribution,
    attribute_capture,
    attribute_report,
    capture_trace_events,
    phase_of,
)

__all__ = [
    "Span", "SpanTracer", "span", "get_tracer", "set_tracer",
    "to_trace_events", "write_chrome_trace", "load_spans",
    "decode_span_payload", "spans_from_dicts",
    "StepPhases", "classify_span", "compute_breakdown",
    "device_phase_fields",
    "PHASES", "DeviceAttribution", "attribute_capture",
    "attribute_report", "capture_trace_events", "phase_of",
    "FlightRecorder",
]
