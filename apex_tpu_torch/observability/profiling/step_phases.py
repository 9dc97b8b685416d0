"""Per-step phase attribution (port of
``apex_tpu/observability/profiling/step_phases.py``).

A step-time number says *that* a step was slow; this module says
*where it went*: the host spans the always-on ring tracer
(:mod:`~apex_tpu_torch.observability.profiling.spans`) recorded inside
the step - pipeline phases, TP/SP collectives, DDP buckets, fused-adam
dispatch - classified into ``data`` / ``comms`` / ``compute``, with the
unattributed remainder reported as ``host``. Fractions are of the step
span's wall time and sum to ~1.0 by construction.

:class:`StepPhases` wraps one training step (``with phases.step():``)
and yields a fields dict made to splat straight into
``StepReporter.step(..., **phases.last_fields())``.

PyTorch runs a CUDA backward on the autograd engine's device thread,
while the calling thread waits in ``backward()``: the DDP overlap
buckets' ``ddp/overlap/bwd_bucket…`` spans and the pipeline backward
land there. :class:`StepPhases` therefore counts the spans of those
threads (:meth:`SpanTracer.foreign_tids`) as the step's own, nested
under whatever the step thread has open, or their comms would read as
compute. :func:`compute_breakdown` with no ``own_tids`` is the
reference's: the step's thread alone.

The device-side fields (:func:`device_phase_fields`) come from a
:class:`~apex_tpu_torch.observability.profiling.xplane.DeviceAttribution`
of a ``torch.profiler`` trace over the same steps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from apex_tpu_torch.observability.profiling.spans import (
    Span,
    SpanTracer,
    get_tracer,
    span,
)

__all__ = [
    "HOST_PHASES", "classify_span", "compute_breakdown", "StepPhases",
    "device_phase_fields",
]

#: phases a host span can land in; ``host`` is the residual.
HOST_PHASES = ("data", "compute", "comms", "host")

# Ordered (phase, prefixes, tokens) rules — FIRST match wins, so
# pp/send_recv (comms) must be tested before the pp/ compute prefix.
_RULES = (
    ("data", ("data",), ("batch", "dataload")),
    ("comms", ("tp/", "sp/", "ddp/", "comms"),
     ("send_recv", "allreduce", "all_gather", "reduce_scatter",
      "scatter", "ppermute", "psum", "broadcast")),
    ("compute", ("pp/", "fused_adam/", "timer/", "compute", "fwd",
                 "bwd", "optimizer"),
     ("forward", "backward", "stage_compute", "grad_accum", "loss",
      "matmul", "attention")),
)


def classify_span(name: str) -> Optional[str]:
    """Host phase for a span name, or None (→ ``host`` residual)."""
    low = (name or "").lower()
    for phase, prefixes, tokens in _RULES:
        if low.startswith(prefixes):
            return phase
        if any(tok in low for tok in tokens):
            return phase
    return None


def _merged(intervals: List[tuple]) -> List[tuple]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _total(intervals: List[tuple]) -> int:
    return sum(e - s for s, e in _merged(intervals))


def _intersection(a: List[tuple], b: List[tuple]) -> int:
    a, b = _merged(a), _merged(b)
    i = j = overlap = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            overlap += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return overlap


#: depth added to the spans of the step's other own threads: they nest
#: under whatever the step thread has open while it waits for them
_FOREIGN_DEPTH = 1 << 16


def compute_breakdown(spans: List[Span], step: Span,
                      own_tids: Optional[set] = None) -> dict:
    """Attribute one step span's wall time across host phases.

    On the step's own thread, every instant is attributed to the
    DEEPEST classified span covering it (a segment sweep — nesting
    never double-counts, at any depth); the residual is ``host``.
    Fractions sum to ~1.0. Classified spans on OTHER threads (async
    data loaders, checkpoint writers) enter the overlap computation
    only.

    ``overlap_efficiency``: intersection of comms-classified and
    compute-classified intervals (all threads, clipped to the step
    window) over the smaller side's total — 1.0 means the cheaper of
    the two was entirely hidden under the other, None when either side
    recorded nothing.

    ``own_tids``: further threads whose spans count as the step's own
    (the autograd engine's device threads), nested under the step
    thread's; None keeps the reference's rule.
    """
    window = (step.start_ns, step.end_ns)
    dur = max(step.end_ns - step.start_ns, 1)
    inside: List[tuple] = []     # (start, end, phase, tid, depth)
    for s in spans:
        if s.seq == step.seq:
            continue
        lo = max(s.start_ns, window[0])
        hi = min(s.end_ns, window[1])
        if hi <= lo:
            continue
        phase = classify_span(s.name)
        if phase is None:
            continue
        if own_tids and s.tid != step.tid and s.tid in own_tids:
            inside.append((lo, hi, phase, step.tid,
                           s.depth + _FOREIGN_DEPTH))
        else:
            inside.append((lo, hi, phase, s.tid, s.depth))

    # on the step's thread, attribute each segment of the window to
    # the DEEPEST classified span covering it — a sweep over the span
    # boundaries. Per-span "self minus descendants" double-subtracts
    # once spans nest 3+ deep (a grandchild is inside its parent AND
    # its grandparent), which misreported 20% of a fully-instrumented
    # pp/forward_backward > pp/forward > pp/stage_compute step as host
    phase_ns = {ph: 0 for ph in HOST_PHASES}
    own = [iv for iv in inside if iv[3] == step.tid]
    points = sorted({p for lo, hi, _p, _t, _d in own for p in (lo, hi)})
    for p0, p1 in zip(points, points[1:]):
        if p1 <= p0:
            continue
        covering = [iv for iv in own if iv[0] <= p0 and iv[1] >= p1]
        if covering:
            deepest = max(covering, key=lambda iv: iv[4])
            phase_ns[deepest[2]] += p1 - p0

    attributed = sum(phase_ns[ph] for ph in ("data", "compute", "comms"))
    phase_ns["host"] = max(dur - attributed, 0)
    fractions = {ph: round(phase_ns[ph] / dur, 4) for ph in HOST_PHASES}

    comms_iv = [(lo, hi) for lo, hi, ph, _t, _d in inside
                if ph == "comms"]
    compute_iv = [(lo, hi) for lo, hi, ph, _t, _d in inside
                  if ph == "compute"]
    overlap = None
    smaller = min(_total(comms_iv), _total(compute_iv))
    if smaller > 0:
        overlap = round(_intersection(comms_iv, compute_iv) / smaller, 4)

    out = {"phases": fractions}
    if overlap is not None:
        out["overlap_efficiency"] = overlap
    return out


def device_phase_fields(attribution) -> dict:
    """Device-side fields from an
    :class:`~apex_tpu_torch.observability.profiling.xplane.DeviceAttribution`
    - merged next to the host breakdown in a step record."""
    out = {"device_phases": attribution.fractions()}
    eff = attribution.overlap_efficiency()
    if eff is not None:
        out["device_overlap_efficiency"] = eff
    return out


class StepPhases:
    """Per-step phase tracker: ``with phases.step(): <train step>``
    brackets the step in a ``step`` span and computes the breakdown of
    everything the ring recorded inside it.

    ``last_fields()`` returns the splat-ready dict
    (``{"phases": {...}, "overlap_efficiency": ...}``) for
    ``StepReporter.step(step_time_s, **phases.last_fields())``.
    """

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 name: str = "step"):
        self._tracer = tracer
        self.name = name
        self._last: Dict = {}

    @property
    def tracer(self) -> SpanTracer:
        return self._tracer if self._tracer is not None else get_tracer()

    @contextlib.contextmanager
    def step(self):
        tracer = self.tracer
        mark = tracer.mark()
        with span(self.name):
            yield
        done = tracer.completed(mark)
        step_span = next(
            (s for s in reversed(done) if s.name == self.name), None)
        if step_span is None:  # ring overflowed within one step
            self._last = {}
            return
        self._last = compute_breakdown(done, step_span,
                                       own_tids=tracer.foreign_tids())

    def last_fields(self) -> dict:
        """The most recent step's breakdown fields ({} before any
        step, or when the ring overflowed mid-step)."""
        return dict(self._last)
