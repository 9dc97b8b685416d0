"""Thread-safe metric registry, the subset ``ServerMetrics`` uses (port of
``apex_tpu/observability/registry.py``).

Counters, gauges, histograms keyed by (name, labels), structured events,
and ``to_records`` in the reference's record shape, so a port dump reads
like a JAX-package dump. Timers, JSONL dump and the fleet stamp wait for
the observability slice.
"""

from __future__ import annotations

import collections
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "get_registry", "set_registry"]

# bounded per-histogram sample reservoir for percentile estimates; the
# exact count/total/min/max are tracked separately and never truncated
_MAX_SAMPLES = 512


class _Metric:
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
    """Exact count/total/min/max plus a bounded reservoir for p50/p90/p99."""

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

    @staticmethod
    def _percentile(sorted_samples, q: float) -> float:
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


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Metrics keyed by (kind, name, labels) plus ordered events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._events: list = []

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

    def event(self, name: str, **fields) -> dict:
        """Append a structured event record; returns it."""
        if not name:
            raise ValueError("event name must be non-empty")
        with self._lock:
            rec = {"type": "event", "name": name, "seq": len(self._events)}
            if fields:
                rec["fields"] = dict(fields)
            self._events.append(rec)
        return rec

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def to_records(self) -> list:
        """Every metric (sorted by type, name) then every event."""
        recs = [m.to_record() for m in self.metrics()]
        recs.sort(key=lambda r: (r["type"], r["name"],
                                 sorted((r.get("labels") or {}).items())))
        return recs + self.events()


_GLOBAL = MetricRegistry()
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
    """The process-wide default registry."""
    return _GLOBAL


def set_registry(registry: MetricRegistry) -> MetricRegistry:
    """Swap the process default; returns the previous registry."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, registry
    return prev
