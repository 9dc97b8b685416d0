"""Fleet flight-record collector — which rank is stuck, and where? (port
of ``apex_tpu/observability/fleet/collector.py``)

On a stall (each rank's own :class:`~apex_tpu_torch.observability.
profiling.flight_recorder.FlightRecorder` watchdog) or an operator
``SIGQUIT`` every rank dumps its own ``flightrec_*.json`` shard,
rank-stamped and collision-free. This module is the join:

- :func:`find_flight_records` — discover the shard set in a directory
  (optionally filtered to one ``run_id``);
- :func:`merge_flight_records` — one fleet verdict: per-rank progress
  (step, elapsed, trigger), each rank's **last collective entered**
  (the grad-sync probe's marker when armed, else the innermost open /
  most recent completed collective-named span), and the **stuck
  rank(s)** — ranks whose dump fired on the stall trigger, else the
  rank furthest behind in step progress, else the longest-hung;
- :func:`write_fleet_record` — persist the merged verdict as a
  ``fleetrec_*.json`` artifact next to the shards.

CLI: ``python -m apex_tpu_torch.observability fleet --flight DIR``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import List, Optional

__all__ = [
    "find_flight_records", "merge_flight_records", "write_fleet_record",
    "COLLECTIVE_SPAN_MARKERS",
]

# span-name prefixes/fragments that mean "inside a collective": the DDP
# bucket schedules, the ZeRO-1 scatter/gather, the raw sync paths, and
# the fleet probe's own barrier-wait region.
COLLECTIVE_SPAN_MARKERS = (
    "ddp/", "zero1", "allreduce", "all_gather", "psum", "reduce_scatter",
    "fleet/barrier", "grad_sync",
)


def _is_collective(name: Optional[str]) -> bool:
    return bool(name) and any(m in name for m in COLLECTIVE_SPAN_MARKERS)


def find_flight_records(directory: str,
                        run_id: Optional[str] = None) -> List[str]:
    """Every ``flightrec_*.json`` under ``directory`` (newest last),
    filtered to ``run_id`` when given (legacy unstamped shards pass a
    None filter only)."""
    paths = sorted(glob.glob(os.path.join(directory, "flightrec_*.json")),
                   key=lambda p: (os.path.getmtime(p), p))
    if run_id is None:
        return paths
    out = []
    for path in paths:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if payload.get("run_id") == run_id:
            out.append(path)
    return out


def _last_collective_of(payload: dict) -> Optional[str]:
    """The collective this rank last entered, best evidence first:
    the probe's explicit marker, then the innermost OPEN span with a
    collective name (where a hung rank is actually parked), then the
    most recent completed collective span in the ring."""
    marker = payload.get("last_collective")
    if marker:
        return marker
    open_spans = payload.get("open_spans") or {}
    for frames in open_spans.values():
        for frame in reversed(frames):  # innermost last
            name = frame.get("name") if isinstance(frame, dict) else None
            if _is_collective(name):
                return name
    best = None
    best_seq = -1
    for span in payload.get("spans") or []:
        name = span.get("name")
        if _is_collective(name) and span.get("seq", -1) > best_seq:
            best, best_seq = name, span.get("seq", -1)
    return best


def merge_flight_records(paths_or_dir,
                         run_id: Optional[str] = None) -> dict:
    """Join per-rank flight-record shards into one fleet verdict.

    Accepts a directory (expanded via :func:`find_flight_records`) or
    an explicit path list. When one rank dumped several times the
    NEWEST shard represents it. Raises FileNotFoundError on an empty
    set — "no post-mortem found" must never read as "fleet healthy".
    """
    if isinstance(paths_or_dir, (list, tuple)):
        paths = list(paths_or_dir)
    else:
        paths = find_flight_records(paths_or_dir, run_id=run_id)
    if not paths:
        raise FileNotFoundError(
            f"no flightrec_*.json shards under {paths_or_dir!r}")

    ranks: dict = {}
    unreadable: list = []
    for path in paths:  # newest-last ordering makes "last write wins"
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            unreadable.append({"path": path, "error": repr(e)[:200]})
            continue
        rank = payload.get("process_index")
        if rank is None:
            rank = f"pid{payload.get('pid', '?')}"
        prev = ranks.get(rank)
        # a stall dump is the evidence this merge exists for — never
        # let a later routine exit/signal dump shadow it
        if prev is not None and prev["trigger"] == "stall" and \
                payload.get("trigger") != "stall":
            continue
        ranks[rank] = {
            "path": os.path.basename(path),
            "trigger": payload.get("trigger"),
            "reason": payload.get("reason"),
            "step": payload.get("step"),
            "step_elapsed_s": payload.get("step_elapsed_s"),
            "last_collective": _last_collective_of(payload),
            "open_span_count": sum(
                len(v) for v in (payload.get("open_spans") or {}).values()),
            "run_id": payload.get("run_id"),
            "process_count": payload.get("process_count"),
        }

    stuck = sorted(r for r, info in ranks.items()
                   if info["trigger"] == "stall")
    picked_by = "stall trigger"
    if not stuck and len(ranks) > 1:
        # no explicit stall dump: the rank furthest BEHIND in step
        # progress is the suspect (everyone else moved on past it)
        steps = {r: info["step"] for r, info in ranks.items()
                 if isinstance(info["step"], int)}
        if steps and max(steps.values()) > min(steps.values()):
            lag = min(steps.values())
            stuck = sorted(r for r, s in steps.items() if s == lag)
            picked_by = "step lag"
    if not stuck:
        hung = {r: info["step_elapsed_s"] for r, info in ranks.items()
                if isinstance(info["step_elapsed_s"], (int, float))}
        if hung:
            worst = max(hung.values())
            stuck = sorted(r for r, v in hung.items() if v == worst)
            picked_by = "longest in-flight step"

    verdict = None
    if stuck:
        first = ranks[stuck[0]]
        where = first.get("last_collective")
        verdict = (f"rank {stuck[0]} stuck at step {first.get('step')}"
                   + (f" in {where}" if where else "")
                   + f" ({picked_by})")
    return {
        "kind": "apex_tpu.fleet_flight_record",
        "schema_version": 1,
        "ranks": {str(k): v for k, v in sorted(
            ranks.items(), key=lambda kv: str(kv[0]))},
        "rank_count": len(ranks),
        "stuck_ranks": [str(r) for r in stuck],
        "picked_by": picked_by if stuck else None,
        "verdict": verdict,
        "unreadable": unreadable,
    }


def write_fleet_record(merged: dict, directory: str) -> str:
    """Persist the merged verdict as ``fleetrec_*.json``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    fname = (f"fleetrec_{time.strftime('%Y%m%d-%H%M%S')}_"
             f"{os.getpid()}.json")
    path = os.path.join(directory, fname)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1, default=repr)
    return path
