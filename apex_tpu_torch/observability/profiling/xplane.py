"""Device-side trace attribution (port of
``apex_tpu/observability/profiling/xplane.py``; the module keeps the
reference's name so that a reader finds its counterpart, but what it
reads is a ``torch.profiler`` trace, not an xplane capture).

Built on the parser and report of :mod:`apex_tpu_torch.pyprof`, it adds
the coarse phase rollup the per-step breakdown needs:

========   =====================================================
phase      fine categories (pyprof.parse)
========   =====================================================
comms      collective, host-transfer
attention  attention-kernel
gather-    gather-scatter
scatter
data-      data-movement (async copies reported separately — they
movement   overlap compute by construction)
compute    matmul, convolution, custom-kernel, rng, reduction,
           fusion-elementwise, control remainder
========   =====================================================

``bytes_accessed`` and ``flops`` are ``None`` (not 0.0) where the trace
measured none: a kernel carries neither, a copy or a fill its bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = [
    "PHASES", "phase_of", "DeviceAttribution", "attribute_report",
    "attribute_capture", "capture_trace_events",
]

# coarse phase -> fine pyprof categories. "compute" is the catch-all:
# anything that is neither communication nor memory traffic is the
# device doing arithmetic (or remainder too small to split).
PHASES = ("compute", "comms", "data-movement", "attention",
          "gather-scatter")

_PHASE_OF_CATEGORY = {
    "collective": "comms",
    "host-transfer": "comms",
    "attention-kernel": "attention",
    "gather-scatter": "gather-scatter",
    "data-movement": "data-movement",
}


def phase_of(category: str) -> str:
    """Coarse phase for a fine pyprof category name."""
    return _PHASE_OF_CATEGORY.get(category, "compute")


@dataclasses.dataclass
class DeviceAttribution:
    """Per-phase device attribution for one trace.

    ``self_us`` sums exclusive op time per phase; ``share`` divides by
    the summed **measured** self time only (phases always sum to ~1.0);
    ``bytes_accessed``/``flops`` are ``None`` when the trace carried no
    such stats, never a fabricated 0.0.
    """

    phases: Dict[str, dict]
    total_self_us: float
    steps_us: List[float]
    async_copy_us: float = 0.0

    @property
    def step_wall_us(self) -> float:
        """Wall time from the ``ProfilerStep#N`` markers (0.0 when the
        trace has none)."""
        return sum(self.steps_us)

    def fractions(self) -> Dict[str, float]:
        """{phase: share of measured self time}; sums to ~1.0 whenever
        any op time was measured."""
        return {ph: rec["share"] for ph, rec in self.phases.items()}

    def overlap_efficiency(self) -> Optional[float]:
        """compute<->comms overlap proxy from device totals: how much of
        the busy time the step wall absorbed. 1.0 = perfectly hidden,
        0.0 = fully serialized. None without step markers or without one
        side."""
        wall = self.step_wall_us
        if not wall:
            return None
        compute = sum(rec["self_us"] for ph, rec in self.phases.items()
                      if ph != "comms")
        comms = self.phases.get("comms", {}).get("self_us", 0.0)
        smaller = min(compute, comms)
        if smaller <= 0:
            return None  # nothing to overlap
        hidden = max(0.0, (compute + comms + self.async_copy_us) - wall)
        return round(min(1.0, hidden / smaller), 4)

    def to_dict(self) -> dict:
        out = {"phases": self.phases,
               "total_self_us": self.total_self_us,
               "async_copy_us": self.async_copy_us}
        if self.steps_us:
            out["steps"] = {"n": len(self.steps_us),
                            "mean_ms": sum(self.steps_us)
                            / len(self.steps_us) / 1e3}
        eff = self.overlap_efficiency()
        if eff is not None:
            out["overlap_efficiency"] = eff
        return out


def attribute_report(report) -> DeviceAttribution:
    """Roll a :class:`apex_tpu_torch.pyprof.prof.Report` up into the
    coarse phase attribution."""
    phases: Dict[str, dict] = {
        ph: {"self_us": 0.0, "occurrences": 0, "flops": None,
             "bytes_accessed": None, "share": 0.0}
        for ph in PHASES}
    for name, cat in report.by_category().items():
        rec = phases[phase_of(name)]
        rec["self_us"] += cat["self_us"]
        rec["occurrences"] += int(cat["occurrences"])
        for field in ("flops", "bytes_accessed"):
            v = cat.get(field)
            if v is not None:
                rec[field] = (rec[field] or 0.0) + v
    total = sum(rec["self_us"] for rec in phases.values())
    for rec in phases.values():
        rec["self_us"] = round(rec["self_us"], 3)
        rec["share"] = round(rec["self_us"] / total, 4) if total else 0.0
    async_us = sum(o.total_us for o in getattr(report, "async_ops", []))
    return DeviceAttribution(phases=phases, total_self_us=round(total, 3),
                             steps_us=list(report.steps_us),
                             async_copy_us=round(async_us, 3))


def attribute_capture(path: str) -> DeviceAttribution:
    """Parse a ``torch.profiler`` trace (file or directory) straight to
    the coarse phase attribution."""
    from apex_tpu_torch.pyprof.prof import Report

    return attribute_report(Report.from_capture(path))


def capture_trace_events(path: str, pid: int = 0) -> List[dict]:
    """A trace's device records as Chrome trace-event dicts (``X``
    complete events, one track per phase) — the device half of
    ``python -m apex_tpu_torch.observability trace``. Event times are
    sequential offsets per phase track (a record keeps durations, not
    start times), so the result shows *where the time went*, not the
    interleaving: the trace itself opens in Perfetto for that."""
    from apex_tpu_torch.pyprof.parse import find_trace_paths, parse_trace
    from apex_tpu_torch.pyprof.prof import DEVICE_LINES

    records = parse_trace(find_trace_paths(path))
    device = [r for r in records if r.plane.startswith("/device:")
              and r.line in DEVICE_LINES]
    if not device:  # a CPU-only trace: the host's ops
        device = records
    else:
        # async copies get their own track, as the attribution sums them
        device = device + [
            r for r in records if r.plane.startswith("/device:")
            and r.line.startswith("Async")]
    tracks: Dict[str, float] = {}
    track_names = PHASES + ("async-copy",)
    tid_of = {ph: i + 1 for i, ph in enumerate(track_names)}
    events: List[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid,
         "tid": tid_of[ph], "args": {"name": f"device/{ph}"}}
        for ph in track_names]
    for rec in device:
        ph = ("async-copy" if rec.line.startswith("Async")
              else phase_of(rec.category))
        cursor = tracks.get(ph, 0.0)
        dur_us = rec.self_ps / 1e6
        events.append({"name": rec.name, "cat": rec.category,
                       "ph": "X", "ts": round(cursor, 3),
                       "dur": round(dur_us, 3),
                       "pid": pid, "tid": tid_of[ph]})
        tracks[ph] = cursor + dur_us
    return events
