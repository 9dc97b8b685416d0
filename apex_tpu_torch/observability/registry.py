"""Thread-safe metric registry (port of
``apex_tpu/observability/registry.py``): the one sink every subsystem
reports through.

- :class:`Counter` / :class:`Gauge` / :class:`Histogram` - the classic
  metric kinds, keyed by (name, labels).
- :class:`Timer` - a histogram of seconds whose ``stop(block_on=...)``
  waits through :func:`apex_tpu_torch.runtime.timing.sync` (a
  ``torch.cuda.synchronize`` on the device of the output's last tensor)
  and subtracts that sync's measured cost; while running it holds an
  :func:`apex_tpu_torch.observability.scope`, so the phase shows up
  named in a ``torch.profiler`` trace.
- :class:`MetricRegistry` - the thread-safe container, with structured
  :meth:`~MetricRegistry.event` records, JSONL export
  (:meth:`~MetricRegistry.dump`) and the merge/summary reader
  (:func:`read_jsonl` / :func:`summarize`).

The record format is the reference's, field for field: a dump either
package writes reads in the other's ``read_jsonl`` and ``summarize``.
torch enters only through ``Timer`` (lazy imports), so the reader side
runs in any process.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricRegistry",
    "get_registry", "set_registry", "read_jsonl", "summarize",
    "append_event",
]

# Bounded per-histogram sample reservoir for percentile estimates; the
# exact count/total/min/max are tracked separately and never truncated.
_MAX_SAMPLES = 512


class _Metric:
    """Shared identity/serialization for all metric kinds."""

    kind = "metric"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()

    def _base_record(self) -> dict:
        rec = {"type": self.kind, "name": self.name}
        if self.labels:
            rec["labels"] = self.labels
        return rec


class Counter(_Metric):
    """Monotonic count (dispatches, retraces, overflows...)."""

    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({n}))")
        with self._lock:
            self.value += n

    def to_record(self) -> dict:
        return {**self._base_record(), "value": self.value}


class Gauge(_Metric):
    """Last-written value (loss scale, device count, a config choice)."""

    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = None

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def to_record(self) -> dict:
        return {**self._base_record(), "value": self.value}


class Histogram(_Metric):
    """Streaming distribution: exact count/total/min/max plus a bounded
    reservoir for p50/p90/p99 estimates."""

    kind = "histogram"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples = collections.deque(maxlen=_MAX_SAMPLES)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self._samples.append(value)

    def _percentile(self, sorted_samples, q: float) -> float:
        idx = min(len(sorted_samples) - 1,
                  int(q * (len(sorted_samples) - 1) + 0.5))
        return sorted_samples[idx]

    def to_record(self) -> dict:
        with self._lock:
            rec = {**self._base_record(), "count": self.count,
                   "total": self.total, "min": self.min, "max": self.max,
                   "mean": (self.total / self.count) if self.count else None}
            if self._samples:
                s = sorted(self._samples)
                rec.update(p50=self._percentile(s, 0.50),
                           p90=self._percentile(s, 0.90),
                           p99=self._percentile(s, 0.99))
        return rec


class Timer(Histogram):
    """A histogram of seconds with start/stop + corrected device sync.

    ``stop(block_on=out)`` waits through
    ``apex_tpu_torch.runtime.timing.sync`` and subtracts the measured
    per-process cost of that sync, so the sync itself never counts as
    phase time. A running timer holds a profiler scope named
    ``timer/<name>`` so phases also land named in traces.

    ``total`` accumulates elapsed seconds across start/stop pairs until
    :meth:`reset_total` — the accumulation contract the reference-shaped
    ``pipeline_parallel.Timers`` adapter needs — while every stop also
    feeds the histogram for JSONL export.
    """

    kind = "timer"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.total_elapsed = 0.0
        self._start: Optional[float] = None
        self._scope_cm = None

    @property
    def running(self) -> bool:
        return self._start is not None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError(f"timer {self.name!r} is already running")
        from apex_tpu_torch.observability.scope import scope
        # manual enter is the Timer's own CM protocol: stop()/cancel()
        # guarantee the paired __exit__ on every path
        # apex-lint: disable=unclosed-span
        self._scope_cm = scope(f"timer/{self.name}")
        self._scope_cm.__enter__()
        self._start = time.perf_counter()

    def stop(self, block_on=None) -> float:
        """End the interval; returns the (corrected) elapsed seconds.

        ``block_on``: tree of tensors the timed region produced - synced
        so the interval covers device execution, with the sync's cost
        subtracted. Omit for host-only regions.
        """
        if self._start is None:
            raise RuntimeError(f"timer {self.name!r} is not running")
        start = self._start
        overhead = 0.0
        try:
            if block_on is not None:
                from apex_tpu_torch.runtime import timing
                # the interval covers the device work it waits for, the
                # sync's measured cost subtracted: the Timer's contract
                timing.sync(block_on)  # apex-lint: disable=sync-timing
                now = time.perf_counter()
                overhead = timing.cached_fetch_cost(block_on)
            else:
                now = time.perf_counter()
        finally:
            # the sync can surface a deferred CUDA error — the timer must
            # not stay wedged "running" with its trace scopes open, or
            # the next start() masks the real failure
            self._start = None
            if self._scope_cm is not None:
                self._scope_cm.__exit__(None, None, None)
                self._scope_cm = None
        elapsed = max(now - start - overhead, 0.0)
        with self._lock:
            self.total_elapsed += elapsed
        self.observe(elapsed)
        return elapsed

    def cancel(self) -> None:
        """Abandon a running interval without recording it (closes the
        trace scope so profiler nesting stays balanced)."""
        self._start = None
        if self._scope_cm is not None:
            self._scope_cm.__exit__(None, None, None)
            self._scope_cm = None

    def reset_total(self) -> float:
        with self._lock:
            total, self.total_elapsed = self.total_elapsed, 0.0
        return total

    @contextlib.contextmanager
    def time(self, block_on_fn=None):
        """``with reg.timer("fwd").time(lambda: out):`` — times the body;
        ``block_on_fn`` (zero-arg) supplies the device output to sync on
        at exit (a callable because the output usually doesn't exist
        until the body ran)."""
        self.start()
        try:
            yield self
            out = block_on_fn() if block_on_fn is not None else None
        except BaseException:
            self.cancel()
            raise
        self.stop(out)

    def to_record(self) -> dict:
        rec = super().to_record()
        rec["total_elapsed"] = self.total_elapsed
        rec["unit"] = "s"
        return rec


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "timer": Timer}


class MetricRegistry:
    """Thread-safe container of metrics + structured events.

    Metric identity is (kind, name, labels): two calls with the same
    coordinates return the SAME object, so call sites never need to
    cache handles. Events are append-only ordered records
    (``seq`` stamps arrival order - wall timestamps are deliberately
    not recorded; ranks on several hosts have no trustworthy shared
    clock and record order is what the readers need).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._events: list = []

    # ------------------------------------------------------------ metrics

    def _get(self, kind: str, name: str, labels: dict):
        if not name:
            raise ValueError("metric name must be non-empty")
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = _KINDS[kind](name, labels)
                self._metrics[key] = metric
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def timer(self, name: str, **labels) -> Timer:
        return self._get("timer", name, labels)

    def event(self, name: str, **fields) -> dict:
        """Append a structured event record; returns it."""
        if not name:
            raise ValueError("event name must be non-empty")
        with self._lock:
            rec = {"type": "event", "name": name, "seq": len(self._events)}
            if fields:
                rec["fields"] = _jsonable(fields)
            self._events.append(rec)
        return rec

    # ------------------------------------------------------------- export

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def to_records(self) -> list:
        """Every metric and event as one JSON-able dict each, metrics
        sorted by (type, name), events in arrival order."""
        recs = [m.to_record() for m in self.metrics()]
        recs.sort(key=lambda r: (r["type"], r["name"],
                                 sorted((r.get("labels") or {}).items())))
        return [_jsonable(r) for r in recs] + self.events()

    def dump(self, path: str, mode: str = "w") -> list:
        """Write one JSONL record per metric/event; returns the records.

        Fleet-aware: a fleet member (``APEX_TPU_PROCESS_*``
        identity set, or process_count > 1) writes to the ``.rank{i}``-
        suffixed variant of ``path`` — two ranks handed the same shared
        path can never interleave — and every record carries the
        ``{process_index, process_count, run_id}`` stamp
        ``merge_fleet`` groups by. Solo processes write ``path``
        verbatim with unstamped records, byte-identical to pre-fleet
        dumps. :meth:`dump_path` is the resolved destination.
        """
        stamp = _fleet_stamp()
        records = self.to_records()
        if stamp:
            records = [dict(rec, **stamp) for rec in records]
        with open(self.dump_path(path), mode) as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return records

    @staticmethod
    def dump_path(path: str) -> str:
        """Where :meth:`dump` actually lands for ``path`` (the
        per-rank suffixed variant for fleet members)."""
        from apex_tpu_torch.observability.fleet.identity import rank_path
        return rank_path(path)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._events.clear()


def _jsonable(value):
    """Best-effort conversion to JSON-encodable values: numpy scalars
    and 0-d tensors become Python numbers, arrays and tensors become
    lists, everything else unknown becomes repr() - a metrics dump must
    never raise."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    item = getattr(value, "item", None)
    if callable(item) and getattr(value, "ndim", None) in (0, None):
        try:
            return item()
        except Exception:  # noqa: BLE001 — fall through to repr
            pass
    tolist = getattr(value, "tolist", None)
    if callable(tolist):
        try:
            return tolist()
        except Exception:  # noqa: BLE001
            pass
    return repr(value)


# --------------------------------------------------------- global default

_GLOBAL = MetricRegistry()
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
    """The process-wide default registry every instrumented subsystem
    reports to unless handed an explicit one."""
    return _GLOBAL


def set_registry(registry: MetricRegistry) -> MetricRegistry:
    """Swap the process default (tests, multi-run tools); returns the
    previous registry."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, registry
    return prev


# ------------------------------------------------------------ file helpers

def append_event(path: str, name: str, **fields) -> dict:
    """Append one structured event record to a metrics JSONL file without
    a registry — for processes (like the bench launcher) that own no
    metrics but must contribute an event.
    Fleet members append to the ``.rank{i}``-suffixed path with the
    identity stamp, like :meth:`MetricRegistry.dump`."""
    rec = {"type": "event", "name": name, "seq": -1, **_fleet_stamp()}
    if fields:
        rec["fields"] = _jsonable(fields)
    with open(MetricRegistry.dump_path(path), "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def _fleet_stamp() -> dict:
    """{process_index, process_count, run_id} for fleet members, {}
    for solo processes (legacy dumps stay byte-identical). Env-driven:
    a metrics write never touches a device."""
    from apex_tpu_torch.observability.fleet.identity import (
        identity_fields,
        is_fleet_member,
        process_identity,
    )

    ident = process_identity()
    return identity_fields(ident) if is_fleet_member(ident) else {}


def read_jsonl(path: str) -> list:
    """Parse a metrics JSONL file; malformed lines are returned as
    ``{"type": "parse-error", ...}`` records rather than raised — a
    truncated dump from a killed worker must still mostly read."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                records.append({"type": "parse-error", "line": i + 1,
                                "error": str(e)})
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                records.append({"type": "parse-error", "line": i + 1,
                                "error": "record is not an object"})
    return records


def summarize(records) -> dict:
    """Merge records (possibly from several dumps of the same run) into
    one summary dict:

    - counters with the same (name, labels) sum;
    - gauges keep the LAST value;
    - histograms/timers merge count/total/min/max exactly (percentiles
      are per-dump estimates and are kept only when a single record
      contributed — merging quantiles would fabricate precision);
    - events are listed in order; parse errors are counted.
    """
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    events = []
    parse_errors = 0

    def key(rec):
        return (rec.get("name", ""),
                tuple(sorted((rec.get("labels") or {}).items())))

    for rec in records:
        rtype = rec.get("type")
        if rtype == "counter":
            counters[key(rec)] = counters.get(key(rec), 0) + \
                (rec.get("value") or 0)
        elif rtype == "gauge":
            gauges[key(rec)] = rec.get("value")
        elif rtype in ("histogram", "timer"):
            k = (rtype,) + key(rec)
            cur = hists.get(k)
            if cur is None:
                hists[k] = {f: rec.get(f) for f in
                            ("count", "total", "min", "max",
                             "p50", "p90", "p99", "unit")}
                hists[k]["type"] = rtype
            else:
                cur["count"] = (cur.get("count") or 0) + \
                    (rec.get("count") or 0)
                cur["total"] = (cur.get("total") or 0.0) + \
                    (rec.get("total") or 0.0)
                for f, pick in (("min", min), ("max", max)):
                    vals = [v for v in (cur.get(f), rec.get(f))
                            if v is not None]
                    cur[f] = pick(vals) if vals else None
                for f in ("p50", "p90", "p99"):
                    cur[f] = None  # cannot merge quantile estimates
        elif rtype == "event":
            events.append(rec)
        elif rtype == "parse-error":
            parse_errors += 1

    def unkey(k):
        name, labels = k
        return name + ("" if not labels else
                       "{" + ",".join(f"{a}={b}" for a, b in labels) + "}")

    for h in hists.values():
        h["mean"] = (h["total"] / h["count"]) if h.get("count") else None
    return {
        "counters": {unkey(k): v for k, v in sorted(counters.items())},
        "gauges": {unkey(k): v for k, v in sorted(gauges.items())},
        "histograms": {t + ":" + unkey((n, l)): v
                       for (t, n, l), v in sorted(hists.items())},
        "events": events,
        "parse_errors": parse_errors,
    }
