"""``python -m apex_tpu_torch.observability {report,trace,fleet,memory,goodput}``
(port of ``apex_tpu/observability/cli.py``; the dumps are one format, so
either package's CLI reads the other's).

``report <metrics.jsonl> [...]`` summarizes one or more metrics JSONL
dumps (a training run's step log, a rank's shard): counters sum, gauges
keep their last value, histogram/timer stats merge exactly, events
print in order. ``--json`` emits the merged summary as JSON for
scripting; ``--events`` limits how many event lines print (default 20,
0 = all).

``trace <run> [--out trace.json]`` exports a Perfetto-loadable
trace-event JSON (open at ``ui.perfetto.dev``) from any of:

- a span dump (``SpanTracer.save``) or a flight record;
- a ``torch.profiler`` trace (a Chrome-trace ``.json`` or ``.json.gz``,
  or a directory of ``*.pt.trace.json`` files, as
  ``apex_tpu_torch.pyprof.stop`` writes them): its device records, one
  track per phase (the reference's xplane branch).

``fleet <base-or-shards...>`` joins ``.rank{i}``-suffixed per-rank
metrics shards into one fleet view: per-rank step-time p50/p99,
cross-rank skew, the merge-time straggler pass, and every
``fleet/straggler`` / ``fleet/desync`` event. Options:

- ``--json`` - the full fleet report as JSON;
- ``--emit-metrics OUT.jsonl`` - write the fleet view as registry-shaped
  records (``fleet/*`` family);
- ``--trace OUT.json`` - merged Perfetto export of the ranks' span
  dumps/flight records, one **pid per rank**;
- ``--flight DIR`` - instead of metrics shards, merge the
  ``flightrec_*`` shards in DIR into the fleet post-mortem naming the
  stuck rank (written as ``fleetrec_*.json`` unless ``--no-write``).

``memory [--out SNAP.json] [--top-k K]`` takes one live memory
snapshot on the card: its name, total memory (``_device.memory``),
live-tensor totals, the top tensors and the allocator's counters.
``--out`` persists it as JSON. The reference's measured-vs-modeled
calibration table waits for ``memory/calibrate.py``.

``goodput <run>`` builds the unified run ledger and prints the goodput
accounting table: ``run`` is a metrics JSONL (any ``.rank{i}`` shard
names its whole family), a directory of run artifacts (every
``*.jsonl`` plus ``flightrec_*``/``memrec_*``/``fleetrec_*``
post-mortems), or a previously saved run-ledger JSON (re-accounted
without re-ingesting). Options:

- ``--wall S`` - the run's real wall-clock seconds; bounds the
  ``unknown`` bucket (events carry no wall timestamps, so idle gaps
  are invisible without it);
- ``--json`` - the accounting object as JSON;
- ``--out LEDGER.json`` - persist the (byte-stable) ledger;
- ``--trace OUT.json`` - Perfetto export, one track per cause;
- ``--records DIR`` / ``--ckpt DIR`` - fold in a post-mortem
  directory / the checkpoint manifest's committed steps.

Exit codes: 0 ok, 1 no records found (goodput: nothing
ledger-relevant; fleet: no shard), 2 bad usage / unreadable file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from apex_tpu_torch.observability.registry import read_jsonl, summarize


def _fmt_num(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _render(summary: dict, events_limit: int) -> str:
    lines = []
    if summary["counters"]:
        lines.append("counters:")
        for name, v in summary["counters"].items():
            lines.append(f"  {name:48s} {_fmt_num(v)}")
    if summary["gauges"]:
        lines.append("gauges:")
        for name, v in summary["gauges"].items():
            lines.append(f"  {name:48s} {_fmt_num(v)}")
    if summary["histograms"]:
        lines.append("histograms:")
        for name, h in summary["histograms"].items():
            parts = [f"n={_fmt_num(h.get('count'))}",
                     f"mean={_fmt_num(h.get('mean'))}",
                     f"min={_fmt_num(h.get('min'))}",
                     f"max={_fmt_num(h.get('max'))}"]
            for q in ("p50", "p90", "p99"):
                if h.get(q) is not None:
                    parts.append(f"{q}={_fmt_num(h[q])}")
            if h.get("unit"):
                parts.append(h["unit"])
            lines.append(f"  {name:48s} " + "  ".join(parts))
    events = summary["events"]
    if events:
        shown = events if events_limit == 0 else events[-events_limit:]
        lines.append(f"events ({len(events)} total, "
                     f"showing {len(shown)}):")
        for ev in shown:
            fields = ev.get("fields") or {}
            body = "  ".join(f"{k}={_fmt_num(v) if not isinstance(v, str) else v}"
                             for k, v in fields.items())
            lines.append(f"  [{ev.get('name')}] {body}")
    if summary["parse_errors"]:
        lines.append(f"({summary['parse_errors']} unparseable line(s) "
                     f"skipped)")
    return "\n".join(lines)


def _trace_events_for(run: str):
    """(events, source_kind) for a run path: a span dump / flight
    record (host spans) or a ``torch.profiler`` trace (device ops)."""
    from apex_tpu_torch.observability import profiling

    if os.path.isfile(run) and run.endswith(".json"):
        with open(run) as f:
            head = json.load(f)
        kind = head.get("kind") if isinstance(head, dict) else None
        sources = {"apex_tpu.spans": "span-dump",
                   "apex_tpu.flight_record": "flight-record"}
        if kind in sources:
            # both dump kinds embed the identical span/thread_names
            # layout; decode the payload already in hand through the
            # one shared schema gate
            spans, names = profiling.decode_span_payload(
                head, where=run, kinds=tuple(sources))
            return profiling.to_trace_events(
                spans, thread_names=names,
                pid=head.get("pid", 0)), sources[kind]
        if not (isinstance(head, dict) and "traceEvents" in head):
            raise ValueError(f"{run}: JSON is neither a span dump, a "
                             f"flight record nor a torch.profiler trace")
    # anything else: a torch.profiler trace file or directory
    return profiling.capture_trace_events(run), "torch-profiler"


def trace_main(args) -> int:
    try:
        events, source = _trace_events_for(args.run)
    except (OSError, ValueError, ImportError) as e:
        print(f"cannot read {args.run}: {e}", file=sys.stderr)
        return 2
    if not any(ev.get("ph") in ("B", "E", "X") for ev in events):
        print(f"no trace events in {args.run}", file=sys.stderr)
        return 1
    base = args.run.rstrip("/")
    out = args.out or (os.path.splitext(base)[0] + ".perfetto.json")
    try:
        with open(out, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
    except OSError as e:
        print(f"cannot write {out}: {e}", file=sys.stderr)
        return 2
    n = sum(1 for ev in events if ev.get("ph") in ("B", "X"))
    print(f"wrote {out} ({n} span(s) from {source}; open at "
          f"ui.perfetto.dev)")
    return 0


def _render_fleet(report: dict) -> str:
    lines = [f"fleet: {report['rank_count']} rank shard(s)"
             + (f" + {report['legacy_shards']} legacy un-suffixed"
                if report.get("legacy_shards") else "")]
    for rank, info in report["ranks"].items():
        ident = info.get("identity") or {}
        run = ident.get("run_id")
        lines.append(f"  rank {rank}: {os.path.basename(info['path'])}"
                     + (f"  run_id={run}" if run else ""))
    for metric, row in sorted(report["step_time_skew"].items()):
        lines.append(f"  {metric}: fleet median p50 "
                     f"{row['fleet_median_p50']:.3f} ms  skew "
                     f"{row['skew']:+.1%} (slowest rank "
                     f"{row['max_rank']})")
        for rank, p50 in sorted(row["p50_by_rank"].items()):
            p99 = row["p99_by_rank"].get(rank)
            p99_s = f"  p99 {p99:.3f}" if isinstance(
                p99, (int, float)) else ""
            lines.append(f"    rank {rank}: p50 {p50:.3f} ms{p99_s}")
    for site, row in sorted(report.get("wait_skew", {}).items()):
        lines.append(f"  grad-sync wait at {site}: fleet median p50 "
                     f"{row['fleet_median_p50_s'] * 1e3:.3f} ms (least: "
                     f"rank {row['min_rank']})")
        for rank, p50 in sorted(row["p50_s_by_rank"].items()):
            lines.append(f"    rank {rank}: p50 {p50 * 1e3:.3f} ms")
    for verdict in report["stragglers"]:
        lines.append(f"  STRAGGLER rank {verdict['rank']} on "
                     f"{verdict['metric']} (skew {verdict['skew']:.2f})")
    for ev in report["fleet_events"]:
        fields = ev.get("fields") or {}
        body = "  ".join(f"{k}={v}" for k, v in fields.items())
        lines.append(f"  [{ev.get('name')}] rank {ev.get('rank')} "
                     f"{body}")
    if not (report["step_time_skew"] or report["fleet_events"]
            or report.get("wait_skew")):
        lines.append("  (no step-time metrics or fleet events in the "
                     "shards)")
    return "\n".join(lines)


def fleet_main(args) -> int:
    from apex_tpu_torch.observability import fleet

    if args.flight:
        try:
            merged = fleet.merge_flight_records(args.flight,
                                                run_id=args.run_id)
        except (OSError, ValueError) as e:
            print(f"cannot merge flight records: {e}", file=sys.stderr)
            return 2 if not isinstance(e, FileNotFoundError) else 1
        if not args.no_write:
            merged["written"] = fleet.write_fleet_record(
                merged, args.flight)
        if args.json:
            print(json.dumps(merged, indent=2))
        else:
            print(f"fleet flight record: {merged['rank_count']} rank(s)")
            for rank, info in merged["ranks"].items():
                where = info.get("last_collective")
                print(f"  rank {rank}: step {info.get('step')} "
                      f"trigger={info.get('trigger')}"
                      + (f" last_collective={where}" if where else ""))
            print(f"  verdict: {merged['verdict'] or 'no stuck rank'}")
            if merged.get("written"):
                print(f"  wrote {merged['written']}")
        return 0
    if not args.paths:
        print("fleet needs shard path(s) or --flight DIR",
              file=sys.stderr)
        return 2
    if args.trace:
        # trace mode: the positional paths are SPAN-DUMP / flight-
        # record shards (rank from the .rank{i} suffix, else the
        # payload's process_index stamp)
        rank_dumps = []
        for path in args.paths:
            rank = fleet.rank_of_path(path)
            if rank is None:
                try:
                    with open(path) as f:
                        rank = json.load(f).get("process_index")
                except (OSError, ValueError) as e:
                    print(f"cannot read {path}: {e}", file=sys.stderr)
                    return 2
            rank_dumps.append((rank, path))
        # legacy shards with neither suffix nor stamp get distinct
        # fallback pids — two of them merging into one Perfetto lane
        # would misrepresent two processes as one
        taken = {r for r, _ in rank_dumps if r is not None}
        next_free = 0
        for i, (rank, path) in enumerate(rank_dumps):
            if rank is None:
                while next_free in taken:
                    next_free += 1
                taken.add(next_free)
                rank_dumps[i] = (next_free, path)
        if len({r for r, _ in rank_dumps}) != len(rank_dumps):
            dupes = sorted(r for r, _ in rank_dumps)
            print(f"duplicate rank(s) across shards: {dupes} — pass "
                  f"one shard per rank", file=sys.stderr)
            return 2
        try:
            events = fleet.fleet_trace_events(rank_dumps)
            with open(args.trace, "w") as f:
                json.dump({"traceEvents": events,
                           "displayTimeUnit": "ms"}, f)
        except (OSError, ValueError) as e:
            print(f"cannot write fleet trace: {e}", file=sys.stderr)
            return 2
        print(f"wrote {args.trace} ({len(rank_dumps)} rank(s), one pid "
              f"per rank; open at ui.perfetto.dev)")
        return 0
    base = args.paths[0] if len(args.paths) == 1 else list(args.paths)
    try:
        report = fleet.merge_fleet(base, run_id=args.run_id)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"cannot merge fleet shards: {e}", file=sys.stderr)
        return 2
    if args.emit_metrics:
        records = fleet.fleet_metric_records(report)
        try:
            with open(args.emit_metrics, "w") as f:
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
        except OSError as e:
            print(f"cannot write {args.emit_metrics}: {e}",
                  file=sys.stderr)
            return 2
        print(f"wrote {args.emit_metrics} ({len(records)} record(s))",
              file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(_render_fleet(report))
    return 0


def memory_main(args) -> int:
    import torch

    from apex_tpu_torch import _device
    from apex_tpu_torch.observability import memory as memory_mod

    try:
        device = _device.resolve(None)
        total, _used = _device.memory(device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    snapshot = memory_mod.memory_snapshot(top_k=args.top_k, device=device)
    payload = {
        "kind": "apex_tpu.memory_snapshot",
        "schema_version": memory_mod.MEMORY_SCHEMA_VERSION,
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "device_count": torch.cuda.device_count(),
        "snapshot": snapshot,
        "device_hbm_bytes": total,
    }
    if args.out:
        try:
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1, default=repr)
        except OSError as e:
            print(f"cannot write {args.out}: {e}", file=sys.stderr)
            return 2
        print(f"wrote {args.out}")
    else:
        print(json.dumps(payload, indent=2, default=repr))
    return 0


def goodput_main(args) -> int:
    import glob as glob_mod

    from apex_tpu_torch.observability import goodput as goodput_mod
    from apex_tpu_torch.observability.fleet.identity import rank_of_path

    run = args.run
    try:
        if os.path.isdir(run):
            ledger = goodput_mod.RunLedger()
            for path in sorted(glob_mod.glob(os.path.join(run,
                                                          "*.jsonl"))):
                ledger.ingest_records(read_jsonl(path),
                                      rank=rank_of_path(path),
                                      where=path)
            ledger.ingest_record_dir(run)
        elif run.endswith(".jsonl"):
            ledger = goodput_mod.RunLedger()
            ledger.ingest_metrics(run)
        else:
            ledger = goodput_mod.RunLedger.load(run)
        if args.records:
            ledger.ingest_record_dir(args.records)
        if args.ckpt:
            ledger.ingest_checkpoints(args.ckpt)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if not ledger.intervals:
        print("no goodput-relevant records found", file=sys.stderr)
        return 1
    accounting, segments = goodput_mod.classify(ledger,
                                                wall_s=args.wall)
    try:
        if args.out:
            ledger.save(args.out)
            print(f"wrote {args.out}", file=sys.stderr)
        if args.trace:
            with open(args.trace, "w") as f:
                json.dump({"traceEvents":
                           goodput_mod.to_trace_events(segments),
                           "displayTimeUnit": "ms"}, f)
            print(f"wrote {args.trace}", file=sys.stderr)
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(accounting, indent=2, sort_keys=True))
    else:
        print(goodput_mod.render(accounting))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.observability",
        description="apex_tpu_torch runtime telemetry tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize metrics JSONL dump(s)")
    rp.add_argument("paths", nargs="+", help="metrics .jsonl file(s)")
    rp.add_argument("--json", action="store_true",
                    help="emit the merged summary as JSON")
    rp.add_argument("--events", type=int, default=20,
                    help="max event lines to print (0 = all)")
    tp = sub.add_parser(
        "trace", help="export a Perfetto trace-event JSON from a span "
                      "dump, flight record, or torch.profiler trace")
    tp.add_argument("run", help="span dump .json, flight record .json, "
                                "or torch.profiler trace file/directory")
    tp.add_argument("--out", default="",
                    help="output path (default: <run>.perfetto.json)")
    fp = sub.add_parser(
        "fleet", help="join per-rank .rank{i} telemetry shards into "
                      "one fleet view")
    fp.add_argument("paths", nargs="*",
                    help="metrics shard base/path(s); with --trace, "
                         "span-dump/flight-record shards")
    fp.add_argument("--json", action="store_true",
                    help="emit the fleet report as JSON")
    fp.add_argument("--run-id", default=None,
                    help="only merge shards stamped with this run_id")
    fp.add_argument("--emit-metrics", default="",
                    help="also write the fleet view as registry-shaped "
                         "JSONL (fleet/* family) to this path")
    fp.add_argument("--trace", default="",
                    help="merged Perfetto export of span-dump shards, "
                         "one pid per rank, to this path")
    fp.add_argument("--flight", default="",
                    help="merge the flightrec_* shards in this "
                         "directory instead of metrics shards")
    fp.add_argument("--no-write", action="store_true",
                    help="with --flight: don't persist the merged "
                         "fleetrec_*.json")
    mp = sub.add_parser(
        "memory", help="live memory snapshot of the card")
    mp.add_argument("--out", default="",
                    help="persist the snapshot JSON here (default: "
                         "print to stdout)")
    mp.add_argument("--top-k", type=int, default=5,
                    help="how many largest buffers the snapshot keeps")
    gp = sub.add_parser(
        "goodput", help="run ledger + goodput accounting")
    gp.add_argument("run",
                    help="metrics .jsonl (any .rank shard names its "
                         "family), a run-artifact directory, or a "
                         "saved run-ledger .json")
    gp.add_argument("--json", action="store_true",
                    help="emit the accounting object as JSON")
    gp.add_argument("--wall", type=float, default=None,
                    help="run wall-clock seconds — bounds the unknown "
                         "bucket (default: sum of attributed time)")
    gp.add_argument("--out", default="",
                    help="persist the run ledger JSON here")
    gp.add_argument("--trace", default="",
                    help="Perfetto export (one track per cause) to "
                         "this path")
    gp.add_argument("--records", default="",
                    help="directory of flightrec_*/memrec_*/fleetrec_* "
                         "post-mortems to fold into the ledger")
    gp.add_argument("--ckpt", default="",
                    help="checkpoint directory — record its committed "
                         "steps in the ledger")
    args = ap.parse_args(argv)
    if args.cmd == "trace":
        return trace_main(args)
    if args.cmd == "fleet":
        return fleet_main(args)
    if args.cmd == "memory":
        return memory_main(args)
    if args.cmd == "goodput":
        return goodput_main(args)

    records = []
    for path in args.paths:
        try:
            records.extend(read_jsonl(path))
        except OSError as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2
    if not records:
        print("no records found", file=sys.stderr)
        return 1
    summary = summarize(records)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(_render(summary, args.events))
    return 0
