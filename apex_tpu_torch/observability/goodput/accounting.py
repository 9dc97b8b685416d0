"""Goodput accounting over a :class:`~.ledger.RunLedger` (port of
``apex_tpu/observability/goodput/accounting.py``, copied).

Classifies every attributable wall-clock second of a run into one
cause (:data:`CAUSES`) and reduces the result to the numbers ROADMAP's
elastic-training story needs: the goodput ratio (fraction of wall time
spent in first-completion training steps), lost-seconds-by-cause, the
badput top-3, and a per-rank skew-adjusted fleet goodput (the slowest
rank gates the fleet, so fleet goodput is the min over ranks).

Attribution policy, per rank in timeline order:

- ``step`` intervals: the first completion of a step index is
  ``productive_step``; any later completion of the same index is
  ``rollback_replay`` (work redone after a rollback/restart is badput
  by definition). When a rank has both loop ``step_done`` events and
  StepReporter ``step`` records, the loop durations win and the
  reporter records only contribute their ``phases`` fractions.
- outlier split: a step slower than ``stall_factor`` x the trailing
  median (the flight recorder's own stall definition) sheds its excess
  over the median — to ``compile`` if it is the first step of an
  attempt (warmup covers (re)tracing + dispatch), else to ``stall``.
  Flight-recorder stall markers in the ledger corroborate but are not
  required — the split is duration-driven, so ledgers from runs
  without a watchdog still account stalls.
- ``data_wait``: a step record carrying StepPhases fractions moves its
  ``phases["data"]`` share of the step to ``data_wait``.
- ``startup`` windows: restore/GC seconds stamped by the loop are
  subtracted (they are accounted under ``ckpt_restore`` and the
  attempt cause directly), the remainder is ``init`` for a cold
  attempt and ``restart`` for a resumed one.
- ``ckpt_save`` / ``ckpt_restore`` / ``preempt_drain`` intervals map
  1:1 from their ``duration_s`` stamps.
- wall minus everything attributed is ``unknown`` — callers that know
  the run's real wall (the examples, the chaos tests) pass ``wall_s`` so idle
  gaps between attempts surface instead of vanishing.

Cause fractions always sum to 1.0 over the accounted wall by
construction.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ledger import RunLedger

__all__ = [
    "ACCOUNTING_KIND", "ACCOUNTING_SCHEMA_VERSION", "CAUSES",
    "FAULT_CAUSES", "STALL_FACTOR", "MIN_STEP_HISTORY", "MIN_STALL_S",
    "account", "classify", "publish", "render", "to_trace_events",
]

ACCOUNTING_KIND = "apex_tpu.goodput_accounting"
ACCOUNTING_SCHEMA_VERSION = 1

#: every wall-clock second lands in exactly one of these.
CAUSES = (
    "productive_step", "init", "compile", "data_wait", "ckpt_save",
    "ckpt_restore", "stall", "preempt_drain", "restart",
    "rollback_replay", "unknown",
)

#: the causes only a fault (injected or real) can produce — an
#: uninterrupted run must report zero seconds in all of them.
FAULT_CAUSES = ("stall", "preempt_drain", "restart", "rollback_replay")

#: outlier threshold, deliberately identical to FlightRecorder's
#: stall_factor so the two tiers agree on what a stall is.
STALL_FACTOR = 3.0
MIN_STEP_HISTORY = 5
#: absolute floor on the excess an outlier step sheds: when steps run
#: in the sub-millisecond range (tiny CPU models), OS scheduler jitter
#: alone clears 3x the median — excess below this is noise, not a
#: stall, and charging it would break the FAULT_CAUSES == 0 invariant
#: for uninterrupted runs.
MIN_STALL_S = 0.05


def _r(x: float) -> float:
    return round(float(x), 6)


def classify(ledger: RunLedger, wall_s: Optional[float] = None,
             stall_factor: float = STALL_FACTOR,
             min_history: int = MIN_STEP_HISTORY
             ) -> Tuple[dict, List[dict]]:
    """(accounting, segments): the accounting summary plus the
    per-interval cause segments the Perfetto export renders."""
    per_rank = {}
    segments: List[dict] = []
    completed = replayed = 0
    for rank in ledger.ranks or [0]:
        causes, segs, stats = _classify_rank(
            ledger.rank_intervals(rank), stall_factor, min_history)
        attributed = sum(causes.values())
        wall = max(wall_s or 0.0, ledger.wall_hints.get(rank, 0.0),
                   attributed)
        unknown = max(0.0, wall - attributed)
        causes["unknown"] = unknown
        if unknown > 0:
            segs.append({"rank": rank, "cause": "unknown",
                         "seconds": unknown, "event": "unattributed"})
        productive = causes["productive_step"]
        ratio = productive / wall if wall > 0 else 0.0
        per_rank[str(rank)] = {
            "wall_s": _r(wall), "productive_s": _r(productive),
            "goodput_ratio": _r(ratio),
            "causes": {c: _r(causes[c]) for c in CAUSES},
        }
        segments.extend(segs)
        completed += stats["completed"]
        replayed += stats["replayed"]

    ranks = sorted(per_rank)
    walls = [per_rank[r]["wall_s"] for r in ranks]
    ratios = [per_rank[r]["goodput_ratio"] for r in ranks]
    total = {c: sum(per_rank[r]["causes"][c] for r in ranks)
             for c in CAUSES}
    wall_total = sum(walls)
    lost = {c: _r(total[c]) for c in CAUSES if c != "productive_step"}
    badput = sorted(((c, s) for c, s in lost.items() if s > 0),
                    key=lambda cs: (-cs[1], cs[0]))[:3]
    accounting = {
        "kind": ACCOUNTING_KIND,
        "schema_version": ACCOUNTING_SCHEMA_VERSION,
        "run_id": ledger.run_id,
        "ranks": [int(r) for r in ranks],
        "wall_s": _r(max(walls) if walls else 0.0),
        "productive_s": _r(total["productive_step"]),
        "goodput_ratio": _r(sum(ratios) / len(ratios) if ratios else 0.0),
        "fleet_goodput": _r(min(ratios) if ratios else 0.0),
        "lost_s": lost,
        "fractions": {c: _r(total[c] / wall_total) if wall_total > 0
                      else 0.0 for c in CAUSES},
        "badput_top": [{"cause": c, "seconds": _r(s)} for c, s in badput],
        "steps": {"completed": completed, "replayed": replayed},
        "per_rank": per_rank,
    }
    return accounting, segments


def account(ledger: RunLedger, wall_s: Optional[float] = None,
            stall_factor: float = STALL_FACTOR,
            min_history: int = MIN_STEP_HISTORY) -> dict:
    """The accounting summary alone (most callers)."""
    return classify(ledger, wall_s, stall_factor, min_history)[0]


def _classify_rank(intervals, stall_factor, min_history):
    causes = {c: 0.0 for c in CAUSES if c != "unknown"}
    segs: List[dict] = []

    def seg(iv, cause, seconds):
        causes[cause] += seconds
        entry = {"rank": iv["rank"], "ord": iv["ord"], "cause": cause,
                 "seconds": seconds}
        for key in ("step", "event"):
            if iv.get(key) is not None:
                entry[key] = iv[key]
        segs.append(entry)

    # a rank with loop step_done events uses those as the step source;
    # reporter records then only carry phases (avoids double counting).
    has_loop = any(iv["kind"] == "step" and iv.get("event") == "step_done"
                   for iv in intervals)
    phase_by_step = {}
    if has_loop:
        for iv in intervals:
            if (iv["kind"] == "step" and iv.get("source") == "reporter"
                    and isinstance(iv.get("phases"), dict)
                    and iv.get("step") is not None):
                phase_by_step[iv["step"]] = iv["phases"]

    # lookahead: a GC window belongs to the attempt it precedes.
    next_resumed = [None] * len(intervals)
    upcoming = None
    for i in range(len(intervals) - 1, -1, -1):
        next_resumed[i] = upcoming
        if intervals[i]["kind"] == "startup":
            upcoming = bool(intervals[i].get("resumed"))

    seen = set()
    pending_restore = pending_gc = 0.0
    attempt_first = False
    steps = []  # (interval, duration, replay, attempt_first)
    for i, iv in enumerate(intervals):
        kind = iv["kind"]
        dur = iv.get("duration_s") or 0.0
        if kind == "step":
            if has_loop and iv.get("source") == "reporter":
                continue
            idx = iv.get("step")
            replay = idx is not None and idx in seen
            if idx is not None:
                seen.add(idx)
            steps.append((iv, dur, replay, attempt_first))
            attempt_first = False
        elif kind == "startup":
            remainder = max(0.0, dur - pending_restore - pending_gc)
            pending_restore = pending_gc = 0.0
            seg(iv, "restart" if iv.get("resumed") else "init", remainder)
            attempt_first = True
        elif kind == "ckpt_restore":
            seg(iv, "ckpt_restore", dur)
            if not iv.get("rollback"):
                pending_restore += dur
        elif kind == "ckpt_gc":
            seg(iv, "restart" if next_resumed[i] else "init", dur)
            pending_gc += dur
        elif kind == "ckpt_save":
            seg(iv, "ckpt_save", dur)
        elif kind == "preempt_drain":
            seg(iv, "preempt_drain", dur)
        # stall/marker intervals carry no seconds of their own

    baseline = [d for _, d, _, first in steps if not first] or \
               [d for _, d, _, _ in steps]
    median = sorted(baseline)[len(baseline) // 2] if baseline else 0.0
    split = len(baseline) >= min_history and median > 0
    for iv, dur, replay, first in steps:
        excess = (dur - median if split and dur > stall_factor * median
                  else 0.0)
        if excess < MIN_STALL_S:
            excess = 0.0
        if excess > 0:
            seg(iv, "compile" if first else "stall", excess)
        remaining = dur - excess
        phases = iv.get("phases") or phase_by_step.get(iv.get("step"))
        frac = (phases or {}).get("data")
        if isinstance(frac, (int, float)) and 0 < frac <= 1:
            data_s = min(remaining, frac * dur)
            if data_s > 0:
                seg(iv, "data_wait", data_s)
                remaining -= data_s
        seg(iv, "rollback_replay" if replay else "productive_step",
            remaining)
    stats = {"completed": sum(1 for _, _, r, _ in steps if not r),
             "replayed": sum(1 for _, _, r, _ in steps if r)}
    return causes, segs, stats


# ------------------------------------------------------- publication

def publish(accounting: dict, registry) -> None:
    """Export the accounting as the ``goodput/*`` gauge family on a
    registry (call it before the final dump so the family rides the
    metrics JSONL)."""
    registry.gauge("goodput/ratio").set(accounting["goodput_ratio"])
    registry.gauge("goodput/fleet_ratio").set(accounting["fleet_goodput"])
    registry.gauge("goodput/wall_s").set(accounting["wall_s"])
    registry.gauge("goodput/productive_s").set(accounting["productive_s"])
    for cause, seconds in sorted(accounting["lost_s"].items()):
        registry.gauge("goodput/lost_s", cause=cause).set(seconds)
    for place, entry in enumerate(accounting["badput_top"], start=1):
        registry.gauge("goodput/badput_rank",
                       cause=entry["cause"]).set(place)
    for rank, pr in sorted(accounting["per_rank"].items()):
        registry.gauge("goodput/rank_ratio",
                       rank=rank).set(pr["goodput_ratio"])
    registry.gauge("goodput/steps_replayed").set(
        accounting["steps"]["replayed"])


def render(accounting: dict) -> str:
    """The human accounting table the CLI prints."""
    lines = []
    run = accounting.get("run_id") or "-"
    lines.append(f"goodput — run {run}, "
                 f"ranks {accounting['ranks'] or [0]}")
    lines.append(f"  wall      {accounting['wall_s']:>12.3f} s")
    lines.append(f"  productive{accounting['productive_s']:>12.3f} s")
    lines.append(f"  goodput   {accounting['goodput_ratio']:>12.4f}"
                 f"   (fleet min {accounting['fleet_goodput']:.4f})")
    steps = accounting["steps"]
    lines.append(f"  steps     {steps['completed']:>8} completed"
                 f"  {steps['replayed']} replayed")
    lines.append("  cause breakdown:")
    fractions = accounting["fractions"]
    for cause in CAUSES:
        if cause == "productive_step":
            continue
        seconds = accounting["lost_s"].get(cause, 0.0)
        if seconds <= 0 and fractions.get(cause, 0.0) <= 0:
            continue
        lines.append(f"    {cause:<16}{seconds:>12.3f} s"
                     f"  {100 * fractions[cause]:>6.2f}%")
    if accounting["badput_top"]:
        top = ", ".join(f"{e['cause']} ({e['seconds']:.3f}s)"
                        for e in accounting["badput_top"])
        lines.append(f"  badput top: {top}")
    else:
        lines.append("  badput top: none — fully attributed to "
                     "productive work")
    return "\n".join(lines)


# ------------------------------------------------------ trace export

def to_trace_events(segments: List[dict]) -> List[dict]:
    """Cause segments -> Chrome trace events: one process per rank,
    one track (tid) per cause, intervals laid end-to-end per rank in
    timeline order (events carry no wall timestamps, so the layout is
    ordinal — durations are real, absolute positions are not)."""
    tids = {cause: i for i, cause in enumerate(CAUSES)}
    events: List[dict] = []
    ranks = sorted({seg["rank"] for seg in segments})
    for rank in ranks:
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
        for cause, tid in tids.items():
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": tid, "args": {"name": cause}})
        cursor = 0.0
        for seg in sorted((s for s in segments if s["rank"] == rank),
                          key=lambda s: s.get("ord", 1 << 30)):
            dur_us = max(0.0, seg["seconds"]) * 1e6
            args = {"cause": seg["cause"]}
            if seg.get("step") is not None:
                args["step"] = seg["step"]
            events.append({"ph": "X", "name": seg.get("event")
                           or seg["cause"], "pid": rank,
                           "tid": tids[seg["cause"]],
                           "ts": round(cursor, 3),
                           "dur": round(dur_us, 3), "cat": "goodput",
                           "args": args})
            cursor += dur_us
    events.sort(key=lambda e: (e.get("ts", -1.0), e["pid"], e["tid"]))
    return events
