"""The unified run ledger (port of
``apex_tpu/observability/goodput/ledger.py``, copied: host code over
record dicts).

A training run scatters its story across artifact families: metrics /
event JSONL (fleet ``.rank*`` shards), span dumps, ``flightrec_*`` /
``memrec_*`` / ``fleetrec_*`` post-mortems and the checkpoint
directory's commit markers. None of them answers *where did the
wall-clock go* on its own: events deliberately carry no wall timestamps
(``seq`` arrival order only - there is no trustworthy shared clock
across hosts), so durations live in the ``duration_s`` / ``startup_s``
stamps the resilience loop writes, in Timer records and in step reports.

:class:`RunLedger` ingests every family and normalizes it into ONE
ordered, rank-aware timeline of typed intervals::

    {"kind": "step", "rank": 0, "ord": 17, "step": 4,
     "duration_s": 0.0021, "source": "loop", ...}

Interval kinds (``INTERVAL_KINDS``) are the raw vocabulary;
:mod:`.accounting` folds them into wall-clock *causes*. The ledger
itself never interprets - it only orders and types, so the same ledger
can be re-accounted under a different policy.

Serialization is schema-versioned (``apex_tpu.run_ledger`` v1, the
reference's), loud on drift (unknown kind/version raises) and
byte-stable: ``load(path).to_json() == open(path).read()`` for any
ledger this module wrote.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

from ..fleet.merge import fleet_shards
from ..registry import read_jsonl

__all__ = [
    "LEDGER_KIND", "LEDGER_SCHEMA_VERSION", "INTERVAL_KINDS",
    "RunLedger", "ledger_from_records",
]

LEDGER_KIND = "apex_tpu.run_ledger"
LEDGER_SCHEMA_VERSION = 1

#: the typed-interval vocabulary. ``marker`` intervals have zero
#: duration — they anchor context (rollbacks, aborts, post-mortem
#: artifacts) on the timeline without claiming wall time.
INTERVAL_KINDS = (
    "step",           # one completed training step (step/step_done)
    "startup",        # attempt bring-up window (attempt_start)
    "ckpt_save",      # checkpoint_saved / checkpoint_failed
    "ckpt_restore",   # resumed / restore_failed
    "ckpt_gc",        # gc_partial_checkpoints
    "preempt_drain",  # preempt_exit (emergency save + drain)
    "stall",          # flight-recorder stall dump marker
    "marker",         # zero-duration context anchor
)

# event name -> ingestion rule. Names and required fields are pinned by
# events.GOODPUT_CRITICAL; the catalog test keeps emitters honest.
_EVENT_KINDS = {
    "step_done": "step",
    "attempt_start": "startup",
    "checkpoint_saved": "ckpt_save",
    "checkpoint_failed": "ckpt_save",
    "resumed": "ckpt_restore",
    "restore_failed": "ckpt_restore",
    "gc_partial_checkpoints": "ckpt_gc",
    "preempt_exit": "preempt_drain",
}
_MARKER_EVENTS = (
    "rollback", "train_aborted", "preemption", "chaos_probe",
    "flight_record", "emergency_save_failed", "emergency_flush_failed",
    "resilience_give_up", "bench_start",
)

# post-mortem record files the directory scan picks up, by filename
# prefix -> the payload kind the file must carry (schema gate).
_RECORD_FAMILIES = {
    "flightrec_": "apex_tpu.flight_record",
    "memrec_": "apex_tpu.memory_record",
    "fleetrec_": "apex_tpu.fleet_flight_record",
}


def _num(value, default=None):
    return float(value) if isinstance(value, (int, float)) else default


class RunLedger:
    """One ordered, rank-aware timeline for a whole run.

    Build empty, then ``ingest_*`` artifact families in any order;
    intervals keep a global ``ord`` so the merged timeline is
    deterministic regardless of ingestion interleaving (per-source
    records stay in their own arrival order).
    """

    def __init__(self, run_id: Optional[str] = None):
        self.run_id = run_id
        self.intervals: List[dict] = []
        self.sources: List[dict] = []
        self.checkpoint_steps: List[int] = []
        self.wall_hints: dict = {}   # rank -> seconds (span coverage)
        self._ord = 0

    # ------------------------------------------------------ ingestion

    def ingest_metrics(self, base: str) -> int:
        """Ingest a metrics JSONL family — ``base`` names any shard,
        the shared path, or a directory; ``.rank*`` siblings join via
        the fleet globber. Returns the number of intervals added."""
        shards = fleet_shards(base)
        if not shards and os.path.isfile(base):
            shards = [(None, base)]
        if not shards:
            raise FileNotFoundError(f"no metrics shards behind {base!r}")
        added = 0
        for rank, path in shards:
            added += self.ingest_records(read_jsonl(path), rank=rank,
                                         where=path)
        return added

    def ingest_records(self, records, rank=None, where="<records>") -> int:
        """Ingest already-parsed metrics records (one shard / registry
        dump). ``rank`` falls back to the fleet identity stamp the
        records carry, then 0."""
        stamped = next((r.get("process_index") for r in records
                        if isinstance(r, dict)
                        and r.get("process_index") is not None), None)
        if rank is None:
            rank = stamped if stamped is not None else 0
        if self.run_id is None:
            self.run_id = next((r.get("run_id") for r in records
                                if isinstance(r, dict) and r.get("run_id")),
                               None)
        added = errors = 0
        for rec in records:
            if not isinstance(rec, dict):
                continue
            rtype = rec.get("type")
            if rtype == "parse-error":
                errors += 1
                continue
            if rtype != "event":
                continue
            added += self._ingest_event(rec, rank)
        self.sources.append({"family": "metrics", "where": where,
                             "rank": rank, "records": len(records),
                             "parse_errors": errors})
        return added

    def _ingest_event(self, rec: dict, rank: int) -> int:
        name = rec.get("name")
        fields = rec.get("fields") or {}
        seq = rec.get("seq")
        kind = _EVENT_KINDS.get(name)
        if kind == "step":
            self._add(kind, rank, seq, event=name,
                      step=fields.get("step"),
                      duration_s=_num(fields.get("duration_s")),
                      phases=fields.get("phases"))
            return 1
        if kind == "startup":
            self._add(kind, rank, seq, event=name,
                      step=fields.get("start_step"),
                      duration_s=_num(fields.get("startup_s")),
                      resumed=bool(fields.get("resumed")))
            return 1
        if kind is not None:
            extra = {}
            if name in ("checkpoint_failed", "restore_failed"):
                extra["failed"] = True
            if name == "resumed" and fields.get("rollback"):
                extra["rollback"] = True
            self._add(kind, rank, seq, event=name,
                      step=fields.get("step"),
                      duration_s=_num(fields.get("duration_s")), **extra)
            return 1
        if name == "step":  # StepReporter record: step_time_ms, phases
            ms = _num(fields.get("step_time_ms"))
            self._add("step", rank, seq, event=name,
                      step=fields.get("step"),
                      duration_s=None if ms is None else ms / 1e3,
                      source="reporter", phases=fields.get("phases"))
            return 1
        if name in _MARKER_EVENTS:
            self._add("marker", rank, seq, event=name,
                      step=fields.get("step"), duration_s=0.0,
                      detail={k: v for k, v in fields.items()
                              if isinstance(v, (str, int, float, bool))})
            return 1
        return 0

    def ingest_span_dump(self, path: str) -> int:
        """Ingest a span dump (or flight record's embedded spans) for
        its wall-clock coverage hint — spans carry the only monotonic
        timestamps in the artifact set, so per-rank coverage bounds the
        accounting's ``unknown`` bucket when no wall is given."""
        from ..profiling.spans import decode_span_payload
        with open(path) as f:
            payload = json.load(f)
        spans, _ = decode_span_payload(
            payload, where=path,
            kinds=("apex_tpu.spans", "apex_tpu.flight_record"))
        rank = payload.get("process_index") or 0
        if spans:
            lo = min(s.start_ns for s in spans)
            hi = max(s.end_ns for s in spans)
            hint = max(0.0, (hi - lo) / 1e9)
            self.wall_hints[rank] = max(self.wall_hints.get(rank, 0.0),
                                        hint)
        self.sources.append({"family": "spans", "where": path,
                             "rank": rank, "records": len(spans),
                             "parse_errors": 0})
        return len(spans)

    def ingest_record_file(self, path: str) -> int:
        """Ingest one flightrec/memrec/fleetrec post-mortem JSON as a
        timeline marker (flight stall dumps become ``stall`` markers —
        corroboration for the accounting's outlier split). Loud on an
        unknown payload kind or schema version."""
        family = next((f for f in _RECORD_FAMILIES
                       if os.path.basename(path).startswith(f)), None)
        with open(path) as f:
            payload = json.load(f)
        kind = payload.get("kind") if isinstance(payload, dict) else None
        if family is not None and kind != _RECORD_FAMILIES[family]:
            raise ValueError(f"{path}: payload kind {kind!r} does not "
                             f"match family {_RECORD_FAMILIES[family]!r}")
        if kind not in _RECORD_FAMILIES.values():
            raise ValueError(f"{path}: unknown record kind {kind!r}")
        version = payload.get("schema_version")
        if version != 1:
            raise ValueError(f"{path}: record schema_version {version!r} "
                             "is unknown to this reader (knows [1])")
        rank = payload.get("process_index") or 0
        trigger = payload.get("trigger")
        ikind = ("stall" if kind == "apex_tpu.flight_record"
                 and trigger == "stall" else "marker")
        detail = {"record_kind": kind}
        for key in ("trigger", "step_elapsed_s", "threshold_s",
                    "verdict", "reason"):
            if isinstance(payload.get(key), (str, int, float, bool)):
                detail[key] = payload[key]
        self._add(ikind, rank, None, event=os.path.basename(path),
                  step=payload.get("step"), duration_s=0.0, detail=detail)
        if kind == "apex_tpu.flight_record" and payload.get("spans"):
            try:
                self.ingest_span_dump(path)
            except ValueError:
                pass
        self.sources.append({"family": "records", "where": path,
                             "rank": rank, "records": 1,
                             "parse_errors": 0})
        return 1

    def ingest_record_dir(self, directory: str) -> int:
        """Scan a directory for flightrec/memrec/fleetrec post-mortems
        and metrics-adjacent span dumps."""
        added = 0
        for prefix in _RECORD_FAMILIES:
            for path in sorted(glob.glob(
                    os.path.join(directory, prefix + "*.json"))):
                added += self.ingest_record_file(path)
        return added

    def ingest_checkpoints(self, directory: str) -> int:
        """Record the committed (valid) checkpoint steps — the
        manifest side of the restore story."""
        from apex_tpu_torch.checkpoint import valid_steps
        steps = valid_steps(directory)
        self.checkpoint_steps = sorted(set(self.checkpoint_steps)
                                       | set(steps))
        self.sources.append({"family": "checkpoints", "where": directory,
                             "rank": None, "records": len(steps),
                             "parse_errors": 0})
        return len(steps)

    def _add(self, kind, rank, seq, **extra):
        if kind not in INTERVAL_KINDS:
            raise ValueError(f"unknown interval kind {kind!r}")
        iv = {"kind": kind, "rank": int(rank or 0), "ord": self._ord,
              "seq": seq}
        iv.update({k: v for k, v in extra.items() if v is not None})
        self.intervals.append(iv)
        self._ord += 1

    # --------------------------------------------------------- access

    @property
    def ranks(self) -> List[int]:
        return sorted({iv["rank"] for iv in self.intervals})

    def rank_intervals(self, rank: int) -> List[dict]:
        return [iv for iv in self.intervals if iv["rank"] == rank]

    # -------------------------------------------------- serialization

    def to_payload(self) -> dict:
        return {
            "kind": LEDGER_KIND,
            "schema_version": LEDGER_SCHEMA_VERSION,
            "run_id": self.run_id,
            "ranks": self.ranks,
            "checkpoint_steps": self.checkpoint_steps,
            "wall_hints": {str(r): v for r, v in
                           sorted(self.wall_hints.items())},
            "sources": self.sources,
            "intervals": self.intervals,
        }

    def to_json(self) -> str:
        """Deterministic, byte-stable serialization: key-sorted,
        fixed separators, trailing newline."""
        return json.dumps(self.to_payload(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def from_payload(cls, payload, where: str = "<payload>") -> "RunLedger":
        if not isinstance(payload, dict) or payload.get("kind") != LEDGER_KIND:
            raise ValueError(f"{where}: not an {LEDGER_KIND} payload")
        version = payload.get("schema_version")
        if version != LEDGER_SCHEMA_VERSION:
            raise ValueError(
                f"{where}: run-ledger schema_version {version!r} is "
                f"unknown to this reader (knows [{LEDGER_SCHEMA_VERSION}])")
        ledger = cls(run_id=payload.get("run_id"))
        ledger.checkpoint_steps = list(payload.get("checkpoint_steps") or [])
        ledger.wall_hints = {int(k): float(v) for k, v in
                             (payload.get("wall_hints") or {}).items()}
        ledger.sources = list(payload.get("sources") or [])
        ledger.intervals = list(payload.get("intervals") or [])
        ledger._ord = 1 + max((iv.get("ord", -1) for iv in ledger.intervals),
                              default=-1)
        return ledger

    @classmethod
    def load(cls, path: str) -> "RunLedger":
        with open(path) as f:
            payload = json.load(f)
        return cls.from_payload(payload, where=path)


def ledger_from_records(records, rank=None, run_id=None) -> RunLedger:
    """One-shot: in-memory registry records -> ledger (no dump
    round-trip needed to account the run just finished)."""
    ledger = RunLedger(run_id=run_id)
    ledger.ingest_records(records, rank=rank)
    return ledger
