"""``python -m apex_tpu_torch.observability {report,trace,memory,goodput}``
(port of ``apex_tpu/observability/cli.py``; the dumps are one format, so
either package's CLI reads the other's).

``report <metrics.jsonl> [...]`` summarizes one or more metrics JSONL
dumps (a training run's step log, a rank's shard): counters sum, gauges
keep their last value, histogram/timer stats merge exactly, events
print in order. ``--json`` emits the merged summary as JSON for
scripting; ``--events`` limits how many event lines print (default 20,
0 = all).

``trace <dump> [--out trace.json]`` exports a Perfetto-loadable
trace-event JSON (open at ``ui.perfetto.dev``) from a span dump
(``SpanTracer.save``) or a flight record. The reference's xplane
branch (a ``jax.profiler`` capture) has no port yet: the xplane /
``pyprof`` slice brings the ``torch.profiler`` counterpart.

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

``fleet`` (the reference's cross-rank merge) exits with a message: it
comes with the rest of the fleet tier.

Exit codes: 0 ok, 1 no records found (goodput: nothing
ledger-relevant), 2 bad usage / unreadable file / not ported yet.
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
    """(events, source_kind) for a span dump / flight record. A device
    capture (the reference's xplane branch) is refused with a
    ValueError naming the slice that ports it."""
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
        raise ValueError(
            f"{run}: JSON is neither a span dump nor a flight record")
    raise ValueError(
        f"{run}: not a span dump or flight record (.json); device "
        f"captures are read by the xplane/pyprof slice, not ported yet")


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


def fleet_main(args) -> int:
    del args
    print("fleet: the cross-rank merge (fleet/merge.py, collector.py) "
          "comes with the rest of the fleet tier, not ported yet "
          "(ROADMAP.md, Queue 1 item 7); read each rank's "
          "<base>.rank<i>.jsonl with `report`", file=sys.stderr)
    return 2


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
                      "dump or flight record")
    tp.add_argument("run", help="span dump .json or flight record .json")
    tp.add_argument("--out", default="",
                    help="output path (default: <run>.perfetto.json)")
    fp = sub.add_parser(
        "fleet", help="join per-rank telemetry shards (not ported yet)")
    fp.add_argument("paths", nargs="*", help="metrics shard path(s)")
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
