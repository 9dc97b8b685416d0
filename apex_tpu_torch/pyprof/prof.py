"""Trace analysis: per-op attribution report from a parsed trace (port of
``apex_tpu/pyprof/prof.py``).

The report aggregates exclusive time per op and per category and derives
utilization against a configurable peak, with the reference's sums and
rounding. :func:`Report.from_capture` reads a ``torch.profiler`` trace
through :mod:`apex_tpu_torch.pyprof.parse`: the device's kernels,
copies and fills when the trace has them, else the host's ops.

The reference also merges the native xprof pipeline's per-op table
(``hlo_stats``: flop rate, bound) when a TPU capture has one. A
``torch.profiler`` trace has no such table, so :func:`xprof_hlo_stats`
returns None; :meth:`Report.merge_hlo_stats` still takes rows in the
reference's schema.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from apex_tpu_torch.pyprof.parse import (
    OpRecord,
    find_trace_paths,
    is_container,
    parse_trace,
    short_name,
    step_times_us,
)

__all__ = ["Report", "OpSummary", "xprof_hlo_stats", "DEVICE_LINES"]

#: the device lines whose records are the ops a report sums: the
#: reference's TPU line and the kernels, copies and fills of a torch trace
DEVICE_LINES = ("XLA Ops", "Kernels", "Memcpy", "Memset")


@dataclasses.dataclass
class OpSummary:
    name: str
    category: str
    program: str
    occurrences: int
    self_us: float
    total_us: float
    share: float = 0.0           # of summed (measured) exclusive time
    # None = the trace carried no flops for this op — distinct from a
    # measured zero, like bytes_accessed
    flops: Optional[float] = None
    # None = the trace carried no bytes for this op — distinct from a
    # measured zero
    bytes_accessed: Optional[float] = None
    gflops_per_s: float = 0.0    # from an hlo_stats table when merged
    bound_by: str = ""


def xprof_hlo_stats(paths) -> Optional[List[Dict]]:
    """The reference's xprof per-op table. A ``torch.profiler`` trace
    has none: always None."""
    del paths
    return None


class Report:
    """Aggregated per-op / per-category attribution for one capture."""

    def __init__(self, ops: List[OpSummary], total_self_us: float,
                 steps_us: Optional[List[float]] = None,
                 async_ops: Optional[List[OpSummary]] = None):
        self.ops = sorted(ops, key=lambda o: -o.self_us)
        self.total_self_us = total_self_us
        # step markers (ProfilerStep#N): the authoritative wall time
        self.steps_us = steps_us or []
        # async-copy spans overlap compute — reported separately, never
        # added into the exclusive-time total
        self.async_ops = sorted(async_ops or [], key=lambda o: -o.self_us)
        for o in self.ops:
            o.share = o.self_us / total_self_us if total_self_us else 0.0
        wall = sum(self.steps_us)
        for o in self.async_ops:
            o.share = o.total_us / wall if wall else 0.0

    # ------------------------------------------------------------ build

    @classmethod
    def from_records(cls, records: List[OpRecord],
                     steps_us: Optional[List[float]] = None) -> "Report":
        """Attribution from the device lines (:data:`DEVICE_LINES`) when
        the records have any, async lines split out; otherwise (a
        host-only trace) every record counts, as the reference does."""
        device_ops = [r for r in records
                      if r.plane.startswith("/device:")
                      and r.line in DEVICE_LINES]
        async_recs = [r for r in records
                      if r.plane.startswith("/device:")
                      and r.line.startswith("Async")]
        main = device_ops if device_ops else records

        def aggregate(recs):
            by_key: Dict[tuple, OpSummary] = {}
            for r in recs:
                if is_container(short_name(r.name)):
                    continue  # a while/call span is its children's time
                key = (short_name(r.name), r.program)
                s = by_key.get(key)
                if s is None:
                    s = by_key[key] = OpSummary(
                        name=key[0], category=r.category,
                        program=r.program,
                        occurrences=0, self_us=0.0, total_us=0.0)
                s.occurrences += 1
                s.self_us += r.self_ps / 1e6
                s.total_us += r.duration_ps / 1e6
                if r.flops is not None:
                    s.flops = (s.flops or 0.0) + r.flops
                if r.bytes_accessed is not None:
                    s.bytes_accessed = (s.bytes_accessed or 0.0) \
                        + r.bytes_accessed
            return list(by_key.values())

        ops = aggregate(main)
        total = sum(s.self_us for s in ops)
        return cls(ops, total, steps_us=steps_us,
                   async_ops=aggregate(async_recs))

    @classmethod
    def from_capture(cls, path: str) -> "Report":
        """Build from a trace file or directory (the newest trace in it)."""
        paths = find_trace_paths(path)
        report = cls.from_records(parse_trace(paths),
                                  steps_us=step_times_us(paths))
        rows = xprof_hlo_stats(paths)
        if rows:
            report.merge_hlo_stats(rows)
        return report

    def merge_hlo_stats(self, rows: List[Dict]) -> None:
        # hlo_stats rows carry a numeric program_id while OpSummary holds
        # the module NAME, so the join key is the op name alone — merge
        # only names that are unambiguous across programs
        counts: Dict[str, int] = {}
        for o in self.ops:
            counts[o.name] = counts.get(o.name, 0) + 1
        by_name = {o.name: o for o in self.ops if counts[o.name] == 1}
        for row in rows:
            o = by_name.get(str(row.get("hlo_op_name", "")))
            if o is None:
                continue
            o.gflops_per_s = float(row.get("model_flop_rate") or 0.0)
            o.bound_by = str(row.get("bound_by") or "")
            if not o.flops and o.gflops_per_s:
                # rate [GFLOP/s] x self time [us] -> flops
                o.flops = o.gflops_per_s * 1e9 * (o.self_us / 1e6)

    # ---------------------------------------------------------- queries

    def by_category(self) -> Dict[str, Dict[str, float]]:
        """Per-category rollup. ``bytes_accessed`` is ``None`` when no
        op in the category carried a measured bytes stat — never a
        fabricated 0.0; ``share`` divides by the summed *measured* self
        time (``total_self_us``)."""
        cats: Dict[str, Dict[str, float]] = {}
        for o in self.ops:
            c = cats.setdefault(o.category, {
                "self_us": 0.0, "occurrences": 0, "flops": None,
                "bytes_accessed": None})
            c["self_us"] += o.self_us
            c["occurrences"] += o.occurrences
            if o.flops is not None:
                c["flops"] = (c["flops"] or 0.0) + o.flops
            if o.bytes_accessed is not None:
                c["bytes_accessed"] = (c["bytes_accessed"] or 0.0) \
                    + o.bytes_accessed
        for c in cats.values():
            c["share"] = (c["self_us"] / self.total_self_us
                          if self.total_self_us else 0.0)
        return dict(sorted(cats.items(), key=lambda kv: -kv[1]["self_us"]))

    def utilization(self, peak_tflops: float,
                    peak_hbm_gbps: Optional[float] = None) -> Dict:
        """Achieved fraction of peak; only meaningful when the records
        carried per-op flops. MFU divides by the step wall time
        (``ProfilerStep`` markers) when present — busy self-time would
        flatter a step with idle gaps."""
        flops = sum(o.flops for o in self.ops if o.flops is not None)
        busy_s = self.total_self_us / 1e6
        wall_s = sum(self.steps_us) / 1e6 or busy_s
        out = {"total_flops": flops, "busy_s": busy_s, "wall_s": wall_s,
               "mfu": (flops / wall_s / (peak_tflops * 1e12))
               if wall_s else 0.0}
        if peak_hbm_gbps:
            measured = [o.bytes_accessed for o in self.ops
                        if o.bytes_accessed is not None]
            # no op carried a bytes stat => HBM utilization is
            # UNMEASURED, not zero — omit rather than mislead
            if measured:
                nbytes = sum(measured)
                out["hbm_util"] = (
                    nbytes / wall_s / (peak_hbm_gbps * 1e9)
                    if wall_s else 0.0)
        return out

    # ----------------------------------------------------------- output

    def format_table(self, top: int = 30) -> str:
        lines = [
            f"{'op':<44} {'category':<18} {'#':>5} {'self ms':>9} "
            f"{'share':>6} {'GFLOP/s':>9} {'bound':>7}",
            "-" * 103,
        ]
        for o in self.ops[:top]:
            lines.append(
                f"{o.name[:44]:<44} {o.category:<18} {o.occurrences:>5} "
                f"{o.self_us / 1e3:>9.3f} {o.share * 100:>5.1f}% "
                f"{o.gflops_per_s:>9.1f} {o.bound_by[:7]:>7}")
        lines.append("-" * 103)
        lines.append(f"{'TOTAL (exclusive)':<69} "
                     f"{self.total_self_us / 1e3:>9.3f}")
        lines.append("")
        lines.append(f"{'category':<24} {'self ms':>10} {'share':>7} "
                     f"{'#ops':>6}")
        for cat, c in self.by_category().items():
            lines.append(
                f"{cat:<24} {c['self_us'] / 1e3:>10.3f} "
                f"{c['share'] * 100:>6.1f}% {int(c['occurrences']):>6}")
        if self.steps_us:
            n = len(self.steps_us)
            lines.append("")
            lines.append(
                f"steps: {n} x {sum(self.steps_us) / n / 1e3:.2f} ms "
                f"(ProfilerStep markers)")
        if self.async_ops:
            tot = sum(o.total_us for o in self.async_ops)
            lines.append(
                f"async copies (overlapped, not in totals): "
                f"{tot / 1e3:.2f} ms across "
                f"{sum(o.occurrences for o in self.async_ops)} spans; top:")
            for o in self.async_ops[:5]:
                lines.append(
                    f"  {o.name[:44]:<44} {o.total_us / 1e3:>9.3f} ms "
                    f"({o.share * 100:.0f}% of wall)")
        return "\n".join(lines)

    def to_dict(self, top: int = 0) -> Dict:
        ops = self.ops[:top] if top else self.ops
        out = {
            "total_self_us": self.total_self_us,
            "categories": self.by_category(),
            "ops": [dataclasses.asdict(o) for o in ops],
        }
        if self.steps_us:
            out["steps"] = {"n": len(self.steps_us),
                            "mean_ms": sum(self.steps_us)
                            / len(self.steps_us) / 1e3}
        if self.async_ops:
            a = self.async_ops[:top] if top else self.async_ops
            out["async_ops"] = [dataclasses.asdict(o) for o in a]
        return out
