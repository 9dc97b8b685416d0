"""Preemption watcher (port of ``apex_tpu/resilience/preemption.py``).

A preempted GPU host (a spot reclaim, a maintenance drain, a scheduler
taking the node back) is turned into ONE thread-safe flag that a loop
polls between iterations:

- POSIX signals (SIGTERM by default: what a reclaimed VM receives);
- pluggable *sensors*: zero-arg callables returning a truthy reason.
  :func:`env_sensor` / :func:`file_sensor` cover tests and manual ops;
  a deployment registers a callable that polls its cloud's maintenance
  notice (``sensors=[my_callable]``).

On trip, the serving engine drains, dumps and raises
:class:`~apex_tpu_torch.resilience.loop.Preempted` or exits with
:data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``: "transient failure, re-run
me"), the exit-code contract schedulers key restarts on. Trips are
counted on the port's metric registry (``resilience/preemptions``,
``resilience/sensor_errors``) with a ``preemption`` event.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, Optional

__all__ = ["EXIT_PREEMPTED", "PreemptionWatcher", "env_sensor",
           "file_sensor"]

#: Resumable exit code (sysexits EX_TEMPFAIL): "preempted, restart me".
EXIT_PREEMPTED = 75


def env_sensor(var: str = "APEX_TPU_PREEMPT") -> Callable[[], str]:
    """Sensor tripping when ``var`` is set non-empty (and not '0')."""

    def sense():
        val = os.environ.get(var, "")
        return f"env {var}={val}" if val not in ("", "0") else ""

    return sense


def file_sensor(path: str) -> Callable[[], str]:
    """Sensor tripping when the sentinel file exists (the classic
    ``touch /tmp/preempt`` operator escape hatch)."""

    def sense():
        return f"sentinel {path}" if os.path.exists(path) else ""

    return sense


class PreemptionWatcher:
    """Signal handler + sensor poll behind one thread-safe flag.

    ``check()`` (called by a loop between iterations) polls every
    sensor, folds signal trips in, and returns the flag; ``trip()``
    sets it manually. Signal handlers install only in the main thread
    (Python's rule) — elsewhere :meth:`install` quietly keeps
    sensor-only operation, so worker-thread loops still preempt via
    sensors.
    """

    def __init__(self, sensors=(), signals=None, registry=None):
        self.sensors = list(sensors)
        self.signals = tuple(signals if signals is not None
                             else (signal.SIGTERM,))
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._reason: Optional[str] = None
        self._installed: dict = {}
        self._registry = registry
        # Written by the signal handler (a plain attribute store is the
        # only async-signal-safe primitive here) and folded into trip()
        # by check() on the polling thread: trip() takes this watcher's
        # lock AND the registry's, and a handler runs ON TOP of
        # whatever frame the interrupted thread holds — tripping inline
        # would deadlock exactly the run it exists to save.
        self._pending_signal: Optional[int] = None

    # ------------------------------------------------------------ state

    @property
    def preempted(self) -> bool:
        # a delivered-but-not-yet-serviced signal counts: the flag must
        # never read False between the handler firing and the next
        # check() folding it in
        return self._event.is_set() or self._pending_signal is not None

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def trip(self, reason: str = "manual") -> None:
        """Flip the flag (idempotent; only the first reason is kept)."""
        with self._lock:
            if self._event.is_set():
                return
            self._reason = reason
            self._event.set()
        reg = self._registry
        if reg is None:
            from apex_tpu_torch.observability import get_registry
            reg = get_registry()
        reg.counter("resilience/preemptions").inc()
        reg.event("preemption", reason=reason)

    def check(self) -> bool:
        """Poll sensors and return the (possibly just-tripped) flag."""
        pending = self._pending_signal
        if pending is not None:
            # service the handler's flag here, on the polling thread,
            # where taking trip()'s locks is safe; a second signal
            # landing between the read and the clear re-reports the
            # same preemption, which trip() dedups
            self._pending_signal = None
            self.trip(f"signal {signal.Signals(pending).name}")
            return True
        if self._event.is_set():
            return True
        for sense in self.sensors:
            try:
                reason = sense()
            except Exception as e:  # a broken sensor must not kill the
                # run it exists to protect — count it and keep polling
                self._sensor_error(e)
                continue
            if reason:
                self.trip(str(reason))
                return True
        return False

    def _sensor_error(self, e: BaseException) -> None:
        reg = self._registry
        if reg is None:
            from apex_tpu_torch.observability import get_registry
            reg = get_registry()
        reg.counter("resilience/sensor_errors").inc()

    # ---------------------------------------------------------- signals

    def _handler(self, signum, frame):
        # async-signal-safe: record the signal and return — trip()
        # acquires this watcher's Lock and the registry's, and this
        # frame may be interrupting a holder of either (the
        # lock-in-signal-handler lint polices the pattern); check()
        # folds the flag in from the polling thread
        self._pending_signal = signum

    def install(self) -> "PreemptionWatcher":
        """Register signal handlers (previous handlers are saved and
        restored by :meth:`uninstall`). Safe off the main thread: signal
        install raises there, and the watcher degrades to sensor-only.
        """
        for sig in self.signals:
            try:
                self._installed[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread — sensors only
                break
        return self

    def uninstall(self) -> None:
        while self._installed:
            sig, prev = self._installed.popitem()
            try:
                signal.signal(sig, prev)
            except ValueError:
                break

    def __enter__(self) -> "PreemptionWatcher":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
