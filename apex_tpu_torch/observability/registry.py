"""Thread-safe metric registry (port of
``apex_tpu/observability/registry.py``): the subset ``ServerMetrics`` and
the resilient training loop use.

Counters, gauges, histograms and timers keyed by (name, labels),
structured events, and ``to_records`` in the reference's record shape,
so a port dump reads like a JAX-package dump. The JSONL dump and the
fleet stamp wait for the observability slice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "Timer", "MetricRegistry",
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


def _sync(tree) -> None:
    """Wait for every CUDA device holding a tensor of ``tree``."""
    import torch

    from apex_tpu_torch import _tree

    for device in {leaf.device for leaf in _tree.flatten(tree)[0]
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(device)


class Timer(Histogram):
    """A histogram of seconds with start/stop (``registry.py:144``).

    ``stop(block_on=out)`` first waits for the devices of the tensors in
    ``out``, so the interval covers their execution. The reference also
    subtracts the round trip of its device fetch, measured through a
    tunnel; a local card has no tunnel, and no correction is made here.
    A running timer holds a profiler scope named ``timer/<name>``
    (``torch.profiler.record_function``), so phases land named in
    traces.

    ``total_elapsed`` accumulates elapsed seconds across start/stop
    pairs; every stop also feeds the histogram.
    """

    kind = "timer"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.total_elapsed = 0.0
        self._start: Optional[float] = None
        self._scope_cm = None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError(f"timer {self.name!r} is already running")
        import torch

        self._scope_cm = torch.profiler.record_function(f"timer/{self.name}")
        self._scope_cm.__enter__()
        self._start = time.perf_counter()

    def _close_scope(self) -> None:
        self._start = None
        if self._scope_cm is not None:
            self._scope_cm.__exit__(None, None, None)
            self._scope_cm = None

    def stop(self, block_on=None) -> float:
        """End the interval; returns the elapsed seconds. ``block_on``:
        the tensors the timed region produced, waited for first. Omit it
        for host-only regions."""
        if self._start is None:
            raise RuntimeError(f"timer {self.name!r} is not running")
        start = self._start
        try:
            if block_on is not None:
                _sync(block_on)
            now = time.perf_counter()
        finally:
            # a sync can surface a deferred device error: the timer must
            # not stay running with its scope open
            self._close_scope()
        elapsed = max(now - start, 0.0)
        with self._lock:
            self.total_elapsed += elapsed
        self.observe(elapsed)
        return elapsed

    def cancel(self) -> None:
        """Abandon a running interval without recording it."""
        self._close_scope()

    def to_record(self) -> dict:
        rec = super().to_record()
        rec["total_elapsed"] = self.total_elapsed
        rec["unit"] = "s"
        return rec


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "timer": Timer}


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

    def timer(self, name: str, **labels) -> Timer:
        return self._get("timer", name, labels)

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
