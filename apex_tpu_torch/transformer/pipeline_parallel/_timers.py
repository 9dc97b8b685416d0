"""Named phase timers (port of
``apex_tpu/transformer/pipeline_parallel/_timers.py``), over the port's
metric registry: every completed interval is also observed into the
registry timer ``pp_phase/<name>``, so pipeline phase times ride the
same records as every other metric.

Usage (the reference's shape)::

    timers = Timers()
    timers("forward").start()
    out = step(batch)
    timers("forward").stop(out)        # waits for out's devices
    timers.log(["forward"], normalizer=n_iters)
"""

from __future__ import annotations

import time
from typing import Optional

from apex_tpu_torch.observability.registry import (
    MetricRegistry,
    get_registry,
)
from apex_tpu_torch.runtime.timing import sync as _sync


class _Timer:
    """One named timer (ref _timers.py:6): start/stop accumulate into this
    timer's own total (two groups never share a running flag), and each
    stop also feeds the shared ``pp_phase/<name>`` metric."""

    def __init__(self, name: str, registry: Optional[MetricRegistry] = None):
        self.name_ = name
        reg = registry if registry is not None else get_registry()
        self._sink = reg.timer(f"pp_phase/{name}")
        self._start: Optional[float] = None
        self._total = 0.0

    @property
    def started_(self) -> bool:
        return self._start is not None

    @property
    def elapsed_(self) -> float:
        return self._total

    def start(self):
        if self._start is not None:
            raise RuntimeError("timer has already been started")
        # Megatron's phase timer is a synchronised host interval (the
        # reference's Timers sync the card, then read the clock)
        self._start = time.perf_counter()  # apex-lint: disable=raw-clock

    def _split(self, block_on=None) -> float:
        # the synchronised host interval start() opened
        if block_on is not None:
            _sync(block_on)  # apex-lint: disable=sync-timing
        # apex-lint: disable=raw-clock
        elapsed = max(time.perf_counter() - self._start, 0.0)
        self._start = None
        self._total += elapsed
        return elapsed

    def stop(self, block_on=None):
        """``block_on``: tensors the timed region produced, waited for
        first, so the interval covers their device work. Omit for
        host-only regions."""
        if self._start is None:
            raise RuntimeError("timer is not started")
        self._sink.observe(self._split(block_on))

    def reset(self):
        self._start = None
        self._total = 0.0

    def elapsed(self, reset: bool = True) -> float:
        started = self._start is not None
        if started:
            # a poll is not a completed phase: the shared metric records
            # real stop() calls only
            self._split()
        elapsed = self._total
        if reset:
            self._total = 0.0
        if started:
            self.start()
        return elapsed


class Timers:
    """Group of named timers (ref _timers.py:51 _Timers)."""

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.timers = {}
        self._registry = registry

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self._registry)
        return self.timers[name]

    def write(self, names, writer, iteration, normalizer: float = 1.0,
              reset: bool = False):
        """Write timings to a tensorboard-style ``writer`` (anything with
        ``add_scalar(tag, value, step)``)."""
        assert normalizer > 0.0
        for name in names:
            if name not in self.timers:
                continue  # same contract as log(): unstarted phases skip
            value = self.timers[name].elapsed(reset=reset) / normalizer
            writer.add_scalar(f"{name}-time", value, iteration)

    def log(self, names, normalizer: float = 1.0, reset: bool = True,
            printer: Optional[callable] = None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name not in self.timers:
                continue  # never-started phases just don't report
            elapsed_time = (self.timers[name].elapsed(reset=reset)
                            * 1000.0 / normalizer)
            string += f" | {name}: {elapsed_time:.2f}"
        if printer is not None:
            printer(string)
        else:
            print(string, flush=True)
