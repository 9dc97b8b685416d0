"""Hierarchical host-side span tracer (port of
``apex_tpu/observability/profiling/spans.py``).

One :func:`span` context manager does three things at once:

- records a (name, thread, start, end, depth) entry into a fixed-size
  **ring buffer** on the process tracer - always on, thread-safe, and
  allocation-free on the hot path (slots are preallocated lists mutated
  in place), so production steps can stay instrumented;
- keeps a per-thread stack of **open** spans, which is what the flight
  recorder snapshots when a step hangs;
- enters :func:`apex_tpu_torch.observability.scope`
  (``torch.profiler.record_function`` plus an NVTX range once CUDA is
  up), so the one call site feeds the ring buffer and a live
  ``torch.profiler`` trace under the same name.

The ring exports as Chrome/Perfetto **trace-event JSON** (``B``/``E``
duration events plus ``M`` thread-name metadata) - load the file at
``ui.perfetto.dev`` or ``chrome://tracing``. ``python -m
apex_tpu_torch.observability trace`` wraps the export for saved dumps.

Clock: ``time.monotonic_ns``. Span times are HOST times - CUDA work
launched inside a span completes asynchronously. PyTorch runs a CUDA
backward on its own autograd thread, so spans opened in backward hooks
land under that thread's ``tid``; the step breakdown
(:mod:`~apex_tpu_torch.observability.profiling.step_phases`) reads every
thread's spans inside the step window.

The dump format (``kind: "apex_tpu.spans"``, schema 1) is the
reference's, so either package's reader loads the other's dumps.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, Optional

__all__ = [
    "Span", "SpanTracer", "span", "get_tracer", "set_tracer",
    "to_trace_events", "write_chrome_trace", "load_spans",
    "spans_from_dicts",
]

# ring slot layout (a plain list, mutated in place — no per-span object
# allocation once the ring has wrapped)
_NAME, _TID, _START_NS, _END_NS, _DEPTH, _SEQ = range(6)

_DEFAULT_CAPACITY = 4096


class Span:
    """Read-only view of one completed span (built lazily by readers —
    the hot path never constructs these)."""

    __slots__ = ("name", "tid", "start_ns", "end_ns", "depth", "seq")

    def __init__(self, name, tid, start_ns, end_ns, depth, seq):
        self.name = name
        self.tid = tid
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.depth = depth
        self.seq = seq

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def to_dict(self) -> dict:
        return {"name": self.name, "tid": self.tid,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "depth": self.depth, "seq": self.seq}


class SpanTracer:
    """Fixed-capacity ring of completed spans + per-thread open stacks.

    ``capacity`` bounds memory forever: a week-long run keeps the last
    ``capacity`` spans, which is exactly what a post-mortem needs. The
    ring slots are preallocated lists; recording a span mutates one
    slot under a short lock — no allocation, no unbounded growth.

    Open-span stacks are kept in a shared ``{tid: stack}`` dict rather
    than ``threading.local`` so the flight recorder's watchdog THREAD
    can snapshot every other thread's in-flight spans mid-hang; each
    stack is only ever mutated by its owner thread.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: List[list] = [
            [None, 0, 0, 0, 0, -1] for _ in range(capacity)]
        self._lock = threading.Lock()
        self._next = 0          # monotonically increasing write seq
        self._stacks: dict = {}  # tid -> [[name, start_ns], ...] (open)
        # every thread that ever recorded, for stable tid numbering
        self._tids: dict = {}
        # threads Python did not start (the autograd engine's device
        # threads, where a CUDA backward and its hooks run)
        self._foreign: set = set()

    # ------------------------------------------------------- hot path

    def begin(self, name: str) -> None:
        """Open a span on the calling thread. Prefer ``with span(...)``;
        the paired :meth:`end` MUST run."""
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            with self._lock:
                stack = self._stacks.setdefault(tid, [])
                thread = threading.current_thread()
                self._tids.setdefault(tid, thread.name)
                if isinstance(thread, threading._DummyThread):
                    self._foreign.add(tid)
        stack.append([name, time.monotonic_ns()])

    def end(self) -> None:
        """Close the innermost open span on the calling thread and
        commit it to the ring."""
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if not stack:
            return  # unbalanced end: drop rather than corrupt the ring
        name, start_ns = stack.pop()
        end_ns = time.monotonic_ns()
        depth = len(stack)
        with self._lock:
            seq = self._next
            self._next = seq + 1
            slot = self._ring[seq % self.capacity]
            slot[_NAME] = name
            slot[_TID] = tid
            slot[_START_NS] = start_ns
            slot[_END_NS] = end_ns
            slot[_DEPTH] = depth
            slot[_SEQ] = seq

    # -------------------------------------------------------- readers

    def mark(self) -> int:
        """Current write position — pass to :meth:`completed` to read
        only spans recorded after this point."""
        with self._lock:
            return self._next

    def completed(self, since: int = 0) -> List[Span]:
        """Completed spans with ``seq >= since`` still in the ring, in
        commit order. Spans older than the ring's capacity are gone —
        that is the ring's contract, not an error."""
        with self._lock:
            slots = [list(s) for s in self._ring if s[_SEQ] >= since]
        slots.sort(key=lambda s: s[_SEQ])
        return [Span(s[_NAME], s[_TID], s[_START_NS], s[_END_NS],
                     s[_DEPTH], s[_SEQ]) for s in slots]

    def dropped(self, since: int = 0) -> int:
        """How many spans recorded after ``since`` have already been
        overwritten (readers must know when the window overflowed)."""
        with self._lock:
            oldest = max(0, self._next - self.capacity)
        return max(0, oldest - since)

    def open_spans(self) -> dict:
        """{tid: [(name, age_s), ...]} of currently-open spans across
        ALL threads — innermost last. This is the flight recorder's
        'where is everyone stuck' snapshot; it is safe to call from any
        thread mid-hang (stacks are copied, owners keep mutating)."""
        now = time.monotonic_ns()
        with self._lock:
            stacks = {tid: list(stack)
                      for tid, stack in self._stacks.items()}
        out = {}
        for tid, stack in stacks.items():
            frames = [(frame[0], (now - frame[1]) / 1e9)
                      for frame in stack]
            if frames:
                out[tid] = frames
        return out

    def thread_names(self) -> dict:
        with self._lock:
            return dict(self._tids)

    def foreign_tids(self) -> set:
        """tids of the recording threads that Python did not start: the
        autograd engine's device threads, on which a CUDA backward runs
        its hooks while the calling thread waits in ``backward()``."""
        with self._lock:
            return set(self._foreign)

    def clear(self) -> None:
        with self._lock:
            for slot in self._ring:
                slot[_NAME] = None
                slot[_SEQ] = -1
            self._next = 0
            self._tids.clear()
            self._foreign.clear()
            self._stacks.clear()

    # --------------------------------------------------------- export

    def to_trace_events(self, since: int = 0) -> List[dict]:
        """Chrome trace-event list (see :func:`to_trace_events`)."""
        return to_trace_events(self.completed(since),
                               thread_names=self.thread_names())

    def write_chrome_trace(self, path: str, since: int = 0) -> int:
        """Write the ring as a Perfetto-loadable trace; returns the
        number of spans exported."""
        spans = self.completed(since)
        write_chrome_trace(path, spans, thread_names=self.thread_names())
        return len(spans)

    @staticmethod
    def save_path(path: str) -> str:
        """Where :meth:`save` actually lands for ``path`` — the
        ``.rank{i}``-suffixed variant for fleet members, ``path``
        verbatim for solo processes (the
        :meth:`MetricRegistry.dump_path` analog)."""
        from apex_tpu_torch.observability.fleet.identity import rank_path
        return rank_path(path)

    def save(self, path: str, since: int = 0) -> int:
        """Persist the raw ring as a span-dump JSON (re-exportable with
        ``python -m apex_tpu_torch.observability trace``); returns the span
        count. Fleet members write the ``.rank{i}``-suffixed
        variant of ``path`` (:meth:`save_path` resolves it) with the
        ``{process_index, process_count, run_id}`` stamp, so concurrent
        rank dumps never clobber."""
        from apex_tpu_torch.observability.fleet.identity import (
            identity_fields,
            is_fleet_member,
            process_identity,
            rank_path,
        )

        spans = self.completed(since)
        payload = {
            "kind": "apex_tpu.spans",
            "schema_version": 1,
            "pid": os.getpid(),
            "thread_names": {str(k): v
                             for k, v in self.thread_names().items()},
            "dropped": self.dropped(since),
            "spans": [s.to_dict() for s in spans],
        }
        ident = process_identity()
        if is_fleet_member(ident):
            payload.update(identity_fields(ident))
        with open(rank_path(path, ident), "w") as f:
            json.dump(payload, f, indent=1)
        return len(spans)


def spans_from_dicts(dicts) -> List[Span]:
    """Decode :meth:`Span.to_dict` records (a span dump's or a flight
    record's ``spans`` list) back into :class:`Span` objects — the ONE
    deserializer for the serialized span schema."""
    return [Span(d["name"], d["tid"], d["start_ns"], d["end_ns"],
                 d.get("depth", 0), d.get("seq", i))
            for i, d in enumerate(dicts)
            if d.get("name") is not None]


def decode_span_payload(payload, where: str = "<payload>",
                        kinds=("apex_tpu.spans",)):
    """(spans, thread_names) from an already-parsed dump payload — the
    ONE schema gate + decoder behind :func:`load_spans` and the CLI's
    trace export (flight records embed the identical span layout under
    their own ``kind``, passed via ``kinds``)."""
    if not isinstance(payload, dict) or payload.get("kind") not in kinds:
        raise ValueError(f"{where}: not an apex_tpu span dump")
    version = payload.get("schema_version")
    if version != 1:
        raise ValueError(f"{where}: span-dump schema_version {version} "
                         f"is unknown to this reader (knows [1])")
    spans = spans_from_dicts(payload.get("spans", []))
    names = {int(k): v for k, v in
             (payload.get("thread_names") or {}).items()}
    return spans, names


def load_spans(path: str):
    """Read a :meth:`SpanTracer.save` dump back as
    (spans, thread_names); raises ValueError on any other JSON."""
    with open(path) as f:
        payload = json.load(f)
    return decode_span_payload(payload, where=path)


# ------------------------------------------------- trace-event export

def to_trace_events(spans, thread_names: Optional[dict] = None,
                    pid: Optional[int] = None) -> List[dict]:
    """Spans → Chrome trace-event dicts (``B``/``E`` pairs + thread-name
    metadata), ready for ``json.dump({"traceEvents": [...]})``.

    Ordering contract:
    ``ts`` is non-decreasing across the whole list, and per (pid, tid)
    every ``B`` has a matching later ``E`` with correct nesting — even
    when a coarse monotonic clock collapses several begins/ends onto
    one timestamp (zero-duration spans included). tids are renumbered
    to small stable ints (sorted by first appearance) so repeated
    exports of the same dump are byte-identical.

    Per thread, the true begin/end sequence is RECONSTRUCTED from the
    ring's commit order: spans commit in post-order (``end()`` pops),
    and a span's descendants commit contiguously just before it at
    greater depths — so nesting never depends on timestamp tie-breaks,
    which cannot disambiguate events a coarse clock stamped alike."""
    pid = os.getpid() if pid is None else pid
    thread_names = thread_names or {}
    spans = sorted(spans, key=lambda s: s.seq)
    # stable small tids: order of first appearance in commit order
    tid_map: dict = {}
    per_tid: dict = {}
    for s in spans:
        if s.tid not in tid_map:
            tid_map[s.tid] = len(tid_map) + 1
        per_tid.setdefault(s.tid, []).append(s)

    def rebuild(tid_spans, tid):
        """Post-order + depth → the chronological event list."""
        pending = []  # chronological [(depth, [event, ...]), ...]
        for s in tid_spans:
            # this span's subtree roots: the trailing pending entries
            # at greater depth (they committed just before it)
            kids = []
            while pending and pending[-1][0] > s.depth:
                kids.append(pending.pop())
            kids.reverse()
            ev = [{"name": s.name, "ph": "B", "ts": s.start_ns / 1e3,
                   "pid": pid, "tid": tid}]
            for _d, sub in kids:
                ev.extend(sub)
            ev.append({"name": s.name, "ph": "E", "ts": s.end_ns / 1e3,
                       "pid": pid, "tid": tid})
            pending.append((s.depth, ev))
        # leftovers are chronological top-level siblings (orphans whose
        # parent never committed — ring wrap — stay top-level)
        return [e for _d, sub in pending for e in sub]

    events = []
    for real_tid, tid in sorted(tid_map.items(), key=lambda kv: kv[1]):
        events.extend(rebuild(per_tid[real_tid], tid))
    # global ts ordering across threads; sorted() is stable, so each
    # thread's reconstructed order (non-decreasing ts by construction)
    # survives ties
    events.sort(key=lambda ev: ev["ts"])
    out = []
    for real_tid, tid in sorted(tid_map.items(), key=lambda kv: kv[1]):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": thread_names.get(
                        real_tid, f"thread-{tid}")}})
    out.extend(events)
    return out


def write_chrome_trace(path: str, spans,
                       thread_names: Optional[dict] = None,
                       pid: Optional[int] = None) -> None:
    """Write spans as a Perfetto/chrome://tracing-loadable JSON file."""
    payload = {
        "traceEvents": to_trace_events(spans, thread_names, pid=pid),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as f:
        json.dump(payload, f)


# ---------------------------------------------------- process default

_TRACER = SpanTracer()
_TRACER_LOCK = threading.Lock()


def get_tracer() -> SpanTracer:
    """The always-on process tracer every :func:`span` records into."""
    return _TRACER


def set_tracer(tracer: SpanTracer) -> SpanTracer:
    """Swap the process tracer (tests, multi-run tools); returns the
    previous one."""
    global _TRACER
    with _TRACER_LOCK:
        prev, _TRACER = _TRACER, tracer
    return prev


@contextlib.contextmanager
def span(name: str):
    """Open a named region on every timeline at once: the span ring
    buffer (host post-mortem) and the live profiler timelines
    (``record_function``, NVTX). The drop-in successor of
    :func:`apex_tpu_torch.observability.scope` - same signature, plus
    the always-on host record."""
    from apex_tpu_torch.observability.scope import scope as _scope

    tracer = get_tracer()
    tracer.begin(name)
    try:
        with _scope(name):
            yield
    finally:
        tracer.end()
