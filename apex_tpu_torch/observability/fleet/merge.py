"""Join per-rank telemetry shards into one fleet view (port of
``apex_tpu/observability/fleet/merge.py``).

Per-rank writers (registry dumps, span dumps, flight records) land at
``.rank{i}``-suffixed paths (:func:`~apex_tpu_torch.observability.fleet.
identity.rank_path`). This module is the reader side:

- :func:`fleet_shards` — discover the shard set behind a base path
  (``metrics.jsonl`` → every ``metrics.rank*.jsonl`` plus, tolerated,
  a legacy un-suffixed ``metrics.jsonl`` itself, reported as rank
  None);
- :func:`merge_fleet` — the fleet report: per-rank summaries and
  step-time p50/p99, cross-rank skew per step-time metric, a
  merge-time straggler pass (trailing-median over each rank's sampled
  step times), and the fleet events (``fleet/straggler``,
  ``fleet/desync``) collected from every shard. Where the shards carry
  the grad-sync probe's ``fleet/grad_sync_wait_s{site=,rank=}`` timers,
  the report also holds ``wait_skew`` and a straggler pass over the
  ranks' median waits per site (mode ``"wait"``: the rank that barely
  waits is the one the others wait for). Each process of a real fleet
  records only its own rank's waits, so this join is where they meet;
  the reference's merge has no such pass (its simulated mesh sees every
  rank's wait in one process);
- :func:`fleet_metric_records` — the report re-encoded as registry-
  shaped JSONL records (``fleet/step_time_skew{metric=}`` gauges,
  per-rank p50/p99 gauges, ``fleet/stragglers{rank=}`` counters,
  ``fleet/ranks``), the reference's family, for a metrics report to
  render and gate on;
- :func:`fleet_trace_events` — Perfetto export of several ranks' span
  dumps/flight records with **rank → pid**, so the merged trace shows
  one process lane per rank at ``ui.perfetto.dev``.

CLI: ``python -m apex_tpu_torch.observability fleet <base-or-shards...>``.
"""

from __future__ import annotations

import glob
import os
import statistics
from typing import List, Optional, Sequence, Tuple

from apex_tpu_torch.observability.fleet.identity import rank_of_path
from apex_tpu_torch.observability.fleet.straggler import StragglerDetector
from apex_tpu_torch.observability.registry import read_jsonl, summarize

__all__ = [
    "fleet_shards", "merge_fleet", "fleet_metric_records",
    "fleet_trace_events", "FLEET_EVENT_NAMES",
]

FLEET_EVENT_NAMES = ("fleet/straggler", "fleet/desync")
WAIT_TIMER = "fleet/grad_sync_wait_s"


def fleet_shards(base: str) -> List[Tuple[Optional[int], str]]:
    """(rank, path) pairs for the shard family behind ``base``.

    ``base`` may be a shared path (its ``.rank*`` siblings are
    globbed; a legacy un-suffixed file at ``base`` itself joins as
    rank None), an existing shard (resolved to its family), or a
    directory (every ``*.rank*.jsonl`` inside). Sorted by rank,
    legacy-unsuffixed last."""
    if os.path.isdir(base):
        paths = sorted(glob.glob(os.path.join(base, "*.rank*.jsonl")))
    else:
        head, tail = os.path.split(base)
        root, ext = os.path.splitext(tail)
        # strip an existing .rank{i} so any shard names its family
        if rank_of_path(base) is not None:
            root = root.rsplit(".rank", 1)[0]
        pattern = os.path.join(head, f"{root}.rank*{ext}")
        paths = sorted(glob.glob(pattern))
        legacy = os.path.join(head, root + ext)
        if os.path.isfile(legacy):
            paths.append(legacy)
    out = []
    for path in paths:
        out.append((rank_of_path(path), path))
    out.sort(key=lambda rp: (rp[0] is None, rp[0] if rp[0] is not None
                             else -1, rp[1]))
    return out


def _identity_of(records) -> dict:
    """The {process_index, process_count, run_id} stamp carried by a
    shard's records (first stamped record wins; legacy dumps carry
    none)."""
    for rec in records:
        if isinstance(rec, dict) and "process_index" in rec:
            return {k: rec.get(k) for k in
                    ("process_index", "process_count", "run_id")
                    if rec.get(k) is not None}
    return {}


def _step_time_stats(records) -> dict:
    """{metric name: {p50, p99, count, mean}} from */step_time_ms
    histogram/timer records."""
    out = {}
    for rec in records:
        name = rec.get("name", "")
        if not (isinstance(name, str) and name.endswith("/step_time_ms")
                and rec.get("type") in ("histogram", "timer")):
            continue
        out[name] = {k: rec.get(k)
                     for k in ("p50", "p99", "count", "mean")}
    return out


def _wait_stats(records) -> dict:
    """{site: {rank: p50 seconds}} from the probe's wait timers."""
    out: dict = {}
    for rec in records:
        labels = rec.get("labels") or {}
        if (rec.get("name") == WAIT_TIMER
                and rec.get("type") in ("histogram", "timer")
                and "site" in labels and "rank" in labels
                and isinstance(rec.get("p50"), (int, float))):
            out.setdefault(labels["site"], {})[int(labels["rank"])] = \
                float(rec["p50"])
    return out


def merge_fleet(base_or_paths, straggler_threshold: Optional[float] = None,
                run_id: Optional[str] = None) -> dict:
    """The one fleet report over a shard family.

    ``base_or_paths``: a shared base path / directory / shard path
    (expanded via :func:`fleet_shards`) or an explicit iterable of
    shard paths. ``run_id`` filters stamped shards to one run (legacy
    unstamped shards always pass). Raises FileNotFoundError when no
    shard exists — an empty fleet report would read as "all healthy".
    """
    if isinstance(base_or_paths, (list, tuple)):
        shards = [(rank_of_path(p), p) for p in base_or_paths]
    else:
        shards = fleet_shards(base_or_paths)
    if not shards:
        raise FileNotFoundError(
            f"no fleet shards found for {base_or_paths!r} (looked for "
            f".rank*-suffixed siblings and the legacy un-suffixed file)")

    ranks: dict = {}
    fleet_events: list = []
    all_records: list = []
    waits: dict = {}     # site -> {rank: p50 wait}
    for rank, path in shards:
        records = read_jsonl(path)
        ident = _identity_of(records)
        if run_id is not None and ident.get("run_id") not in (None,
                                                              run_id):
            continue
        if rank is None:
            rank = ident.get("process_index")
        key = "legacy" if rank is None else int(rank)
        ranks[key] = {
            "path": path,
            "identity": ident,
            "summary": summarize(records),
            "step_time": _step_time_stats(records),
        }
        all_records.extend(records)
        for site, per_rank in _wait_stats(records).items():
            waits.setdefault(site, {}).update(per_rank)
        for rec in records:
            if rec.get("type") == "event" and \
                    rec.get("name") in FLEET_EVENT_NAMES:
                fleet_events.append({"rank": key, **rec})

    # ---- cross-rank skew + merge-time straggler pass
    numeric_ranks = sorted(k for k in ranks if isinstance(k, int))
    skew: dict = {}
    stragglers: list = []
    metrics = sorted({m for k in numeric_ranks
                      for m in ranks[k]["step_time"]})
    for metric in metrics:
        per_rank = {k: ranks[k]["step_time"][metric]
                    for k in numeric_ranks
                    if metric in ranks[k]["step_time"]
                    and isinstance(ranks[k]["step_time"][metric].get(
                        "p50"), (int, float))}
        if len(per_rank) < 2:
            continue
        p50s = {k: float(v["p50"]) for k, v in per_rank.items()}
        fleet_median = statistics.median(p50s.values())
        slow = max(p50s, key=lambda k: p50s[k])
        rel = ((p50s[slow] - fleet_median) / fleet_median
               if fleet_median > 0 else 0.0)
        skew[metric] = {
            "p50_by_rank": p50s,
            "p99_by_rank": {k: v.get("p99")
                            for k, v in per_rank.items()},
            "fleet_median_p50": fleet_median,
            "max_rank": slow,
            "skew": round(rel, 4),
        }
        detector = StragglerDetector(
            mode="step_time", threshold=straggler_threshold,
            min_history=1, registry=_NullRegistry())
        # rank-keyed mapping: a sparse shard family (some ranks never
        # dumped) must not fabricate phantom ranks
        verdict = detector.observe(0, p50s, site=metric)
        if verdict is not None:
            stragglers.append({"metric": metric, **verdict})

    report = {
        "kind": "apex_tpu.fleet_report",
        "schema_version": 1,
        "ranks": ranks,
        "rank_count": len(numeric_ranks),
        "legacy_shards": int("legacy" in ranks),
        "step_time_skew": skew,
        "stragglers": stragglers,
        "fleet_events": fleet_events,
    }
    # ---- the grad-sync waits of the ranks, where the probe was on
    wait_skew: dict = {}
    for site, per_rank in sorted(waits.items()):
        if len(per_rank) < 2:
            continue
        detector = StragglerDetector(
            mode="wait", threshold=straggler_threshold, min_history=1,
            registry=_NullRegistry())
        verdict = detector.observe(0, per_rank, site=site)
        wait_skew[site] = {
            "p50_s_by_rank": dict(sorted(per_rank.items())),
            "fleet_median_p50_s": statistics.median(per_rank.values()),
            "min_rank": min(per_rank, key=lambda k: per_rank[k])}
        if verdict is not None:
            stragglers.append({"metric": f"{WAIT_TIMER}{{site={site}}}",
                               **verdict})
    if wait_skew:
        report["wait_skew"] = wait_skew
    return report


class _NullRegistry:
    """Metric sink for merge-time detector passes: the merge is a
    READER — it must not publish into the live process registry."""

    def counter(self, *a, **k):
        return self

    def gauge(self, *a, **k):
        return self

    def inc(self, *a, **k):
        return None

    def set(self, *a, **k):
        return None

    def event(self, *a, **k):
        return {}


def fleet_metric_records(report: dict) -> list:
    """The fleet report as registry-shaped JSONL records (the
    reference's ``fleet/*`` family)."""
    recs = [{"type": "gauge", "name": "fleet/ranks",
             "value": report["rank_count"]}]
    for metric, row in sorted(report["step_time_skew"].items()):
        recs.append({"type": "gauge", "name": "fleet/step_time_skew",
                     "labels": {"metric": metric},
                     "value": row["skew"]})
        for rank, p50 in sorted(row["p50_by_rank"].items()):
            recs.append({"type": "gauge",
                         "name": "fleet/step_time_p50_ms",
                         "labels": {"metric": metric,
                                    "rank": str(rank)},
                         "value": p50})
        for rank, p99 in sorted(row["p99_by_rank"].items()):
            if p99 is not None:
                recs.append({"type": "gauge",
                             "name": "fleet/step_time_p99_ms",
                             "labels": {"metric": metric,
                                        "rank": str(rank)},
                             "value": p99})
    by_rank: dict = {}
    for verdict in report["stragglers"]:
        by_rank[verdict["rank"]] = by_rank.get(verdict["rank"], 0) + 1
    for rank, n in sorted(by_rank.items()):
        recs.append({"type": "counter", "name": "fleet/stragglers",
                     "labels": {"rank": str(rank)}, "value": n})
    recs.append({"type": "counter", "name": "fleet/desync_events",
                 "value": sum(1 for ev in report["fleet_events"]
                              if ev.get("name") == "fleet/desync")})
    for i, ev in enumerate(report["fleet_events"]):
        recs.append({"type": "event", "name": ev.get("name"),
                     "seq": i, "fields": {
                         "rank": ev.get("rank"),
                         **(ev.get("fields") or {})}})
    return recs


def fleet_trace_events(rank_dumps: Sequence[Tuple[int, str]]) -> list:
    """Merged Perfetto trace events over several ranks' span dumps /
    flight records, one **pid per rank** so the fleet renders as one
    process lane per rank. ``rank_dumps``: (rank, path) pairs."""
    import json

    from apex_tpu_torch.observability.profiling import (
        decode_span_payload,
        to_trace_events,
    )

    events: list = []
    kinds = ("apex_tpu.spans", "apex_tpu.flight_record")
    for rank, path in sorted(rank_dumps):
        with open(path) as f:
            payload = json.load(f)
        spans, names = decode_span_payload(payload, where=path,
                                           kinds=kinds)
        pid = int(rank)
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"rank{pid}"}})
        events.extend(to_trace_events(spans, thread_names=names,
                                      pid=pid))
    return events
