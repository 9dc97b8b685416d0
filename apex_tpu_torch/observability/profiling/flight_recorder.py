"""Stall flight recorder (port of
``apex_tpu/observability/profiling/flight_recorder.py``).

A hung step leaves nothing behind unless something is watching; the
flight recorder makes every run leave a post-mortem:

- a **watchdog thread** polls the in-flight step. A step is *stalled*
  when it exceeds ``stall_factor ×`` the trailing-median step time
  (once ``min_history`` steps are recorded) or a hard ``deadline_s``
  wall limit - whichever is tighter;
- a **SIGQUIT handler** (``kill -QUIT``) triggers the same dump on
  demand from an operator;
- the **dump artifact** is one timestamped ``flightrec_*.json``: the
  span ring buffer (completed + per-thread *open* spans - where
  everyone is stuck), every thread's Python stack, the last N registry
  events, the counter snapshot, the step-time history that defined
  "stalled", and the memory tier's section (live CUDA bytes, the
  watermark, the largest tensors).

Wire-up is one call: pass ``flight_recorder=recorder`` to
``ResilientTrainLoop`` (the loop drives the
``step_started``/``step_finished`` pair itself), or wrap a bare step
function with ``recorder.wrap_step(step_fn)``; never both.
``recorder.sensor()`` plugs into a ``PreemptionWatcher`` so a stalled
step can be escalated into the emergency-checkpoint + exit-75 path.

The dump's fleet fields (``last_collective``, ``last_collectives``) are
the grad-sync probe's (:mod:`~apex_tpu_torch.observability.fleet.probe`):
the last collective this process's rank entered (None and ``{}`` while
the probe is off or has seen none), which
:func:`~apex_tpu_torch.observability.fleet.merge_flight_records` reads
to say where a stuck rank is stuck.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import statistics
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from apex_tpu_torch.observability.profiling.spans import SpanTracer, get_tracer

__all__ = ["FlightRecorder", "DEFAULT_STALL_FACTOR", "thread_stacks"]

DEFAULT_STALL_FACTOR = 3.0


def thread_stacks() -> dict:
    """Every thread's Python stack, keyed by thread id — the shared
    post-mortem ingredient of flight records and the memory tier's
    ``memrec_*.json`` OOM artifacts."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for tid, frame in sys._current_frames().items():
        stacks[str(tid)] = {
            "thread": names.get(tid, f"thread-{tid}"),
            "stack": [line.rstrip("\n") for line in
                      traceback.format_stack(frame)],
        }
    return stacks

# process-wide dump serial: two recorders (or two dumps of one) in the
# same second share a timestamp AND a pid - the serial is what keeps
# their artifact names distinct
_DUMP_SEQ = itertools.count()


def _default_dir() -> str:
    return os.environ.get("APEX_TPU_FLIGHT_DIR", os.getcwd())


def _memory_section():
    """The memory tier's flight block, degraded to None on any
    failure (a post-mortem must never take down the run it observes)."""
    try:
        from apex_tpu_torch.observability.memory import hbm
        return hbm.flight_section()
    except Exception:  # noqa: BLE001 — diagnostics only
        return None


class FlightRecorder:
    """Watchdog + SIGQUIT handler + dump writer behind one object.

    Parameters
    ----------
    directory: where dump artifacts land (``APEX_TPU_FLIGHT_DIR`` env
        default, else cwd).
    stall_factor: a step slower than ``stall_factor × trailing
        median`` is stalled (needs ``min_history`` completed steps).
    min_history / history: how many completed step times arm / feed
        the trailing median.
    deadline_s: hard wall limit per step regardless of history (None
        disables; this is what catches a hang on step 0).
    poll_s: watchdog poll cadence.
    max_events: how many trailing registry events the dump carries.
    signals: signals that force a dump (default SIGQUIT); install only
        works on the main thread — elsewhere the watchdog still runs
        (the PreemptionWatcher degradation contract).
    """

    def __init__(self, *, directory: Optional[str] = None,
                 tracer: Optional[SpanTracer] = None, registry=None,
                 stall_factor: float = DEFAULT_STALL_FACTOR,
                 min_history: int = 5, history: int = 64,
                 deadline_s: Optional[float] = None, poll_s: float = 0.5,
                 max_events: int = 100, signals=None):
        if stall_factor <= 1.0:
            raise ValueError(
                f"stall_factor must be > 1 (got {stall_factor}): at "
                f"<= 1 every median step is a 'stall'")
        self.directory = directory or _default_dir()
        self._tracer = tracer
        self._registry = registry
        self.stall_factor = float(stall_factor)
        self.min_history = int(min_history)
        self.deadline_s = deadline_s
        self.poll_s = float(poll_s)
        self.max_events = int(max_events)
        if signals is None:
            # resolved here, not in the def default: SIGQUIT does not
            # exist on Windows and a default argument evaluates at
            # import time
            sigquit = getattr(signal, "SIGQUIT", None)
            signals = (sigquit,) if sigquit is not None else ()
        self.signals = tuple(signals)
        self._history: deque = deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._step: Optional[int] = None       # in-flight step index
        self._step_started: Optional[float] = None
        self._dumped_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._installed: dict = {}
        self._stall_reason: Optional[str] = None
        # set by the signal handler, serviced by the watchdog thread:
        # dump() takes the recorder's and the registry's locks, and a
        # handler runs ON TOP of whatever main-thread frame holds them
        # — dumping inline would deadlock the process it post-mortems
        self._signal_pending = threading.Event()
        self._signal_name = ""
        self.dumps: list = []                  # paths written this run

    # ------------------------------------------------------- plumbing

    @property
    def tracer(self) -> SpanTracer:
        return self._tracer if self._tracer is not None else get_tracer()

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability import get_registry
        return get_registry()

    # ------------------------------------------------------ step feed

    def step_started(self, step: int) -> None:
        with self._lock:
            self._step = int(step)
            self._step_started = time.monotonic()
            # a fresh attempt re-arms detection even for a replayed
            # index: _dumped_step dedups watchdog polls within one
            # attempt, it must not stop a rolled-back-and-replayed
            # step from ever dumping again
            self._dumped_step = None

    def step_finished(self, duration_s: Optional[float] = None,
                      record: bool = True) -> None:
        """Close the in-flight step. ``record=False`` clears the marker
        without feeding the trailing-median history — for attempts that
        RAISED: their near-zero duration is not a step time, and under
        a retry storm it would collapse the median until every healthy
        step read as a stall."""
        with self._lock:
            if duration_s is None and self._step_started is not None:
                duration_s = time.monotonic() - self._step_started
            if record and duration_s is not None:
                self._history.append(float(duration_s))
            self._step = None
            self._step_started = None

    def wrap_step(self, step_fn: Callable) -> Callable:
        """``step_fn(state, step) -> (state, metrics)`` instrumented
        with the started/finished pair — hand the result to
        ``ResilientTrainLoop``."""
        def recorded(state, step):
            self.step_started(step)
            try:
                out = step_fn(state, step)
            except BaseException:
                self.step_finished(record=False)
                raise
            self.step_finished()
            return out
        return recorded

    def threshold_s(self) -> Optional[float]:
        """Current stall threshold: min(stall_factor × trailing
        median, deadline_s) — None while both legs are unarmed."""
        with self._lock:
            hist = list(self._history)
        legs = []
        if len(hist) >= self.min_history:
            legs.append(self.stall_factor * statistics.median(hist))
        if self.deadline_s is not None:
            legs.append(float(self.deadline_s))
        return min(legs) if legs else None

    @property
    def stalled(self) -> bool:
        return self._stall_reason is not None

    def sensor(self) -> Callable[[], str]:
        """A ``PreemptionWatcher``-shaped sensor: truthy (the stall
        reason) once a stall dump fired — lets a deployment escalate a
        hung step into the emergency-checkpoint + exit-75 path."""
        def sense():
            return self._stall_reason or ""
        return sense

    # ------------------------------------------------------- watchdog

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._signal_pending.is_set():
                self._signal_pending.clear()
                self.dump(reason=f"signal {self._signal_name}",
                          kind="signal")
            with self._lock:
                started = self._step_started
                step = self._step
            if started is None or step == self._dumped_step:
                continue
            limit = self.threshold_s()
            if limit is None:
                continue
            elapsed = time.monotonic() - started
            if elapsed > limit:
                reason = (f"step {step} stalled: {elapsed:.3f}s "
                          f"> threshold {limit:.3f}s")
                # same lock step_started() holds to clear _dumped_step:
                # an unlocked write here races the step thread re-arming
                # a replayed step. dump() stays OUTSIDE the lock — it
                # opens files and takes this lock again for its state
                # snapshot.
                with self._lock:
                    self._dumped_step = step
                    self._stall_reason = reason
                self.dump(reason=reason, kind="stall")

    def install(self) -> "FlightRecorder":
        """Start the watchdog thread and register the dump signals
        (main thread only — elsewhere the watchdog still arms)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="apex-flight-recorder",
                daemon=True)
            self._thread.start()
        for sig in self.signals:
            if sig in self._installed:  # re-install would save our own
                continue                # handler as the "previous" one
            try:
                self._installed[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread — watchdog only
                break
        return self

    def uninstall(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        while self._installed:
            sig, prev = self._installed.popitem()
            try:
                signal.signal(sig, prev)
            except ValueError:
                break

    def __enter__(self) -> "FlightRecorder":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        # async-signal-safe: only flag the request — the watchdog
        # thread does the actual dump (which takes locks the
        # interrupted frame may hold)
        self._signal_name = signal.Signals(signum).name
        self._signal_pending.set()

    # ----------------------------------------------------------- dump

    def _thread_stacks(self) -> dict:
        return thread_stacks()

    def dump(self, reason: str = "manual",
             kind: str = "manual") -> Optional[str]:
        """Write the post-mortem artifact; returns its path (None when
        even the write failed — the recorder must never take down the
        run it observes)."""
        from apex_tpu_torch.observability.fleet import probe as fleet_probe
        from apex_tpu_torch.observability.fleet.identity import (
            FleetIdentity,
            identity_fields,
            process_identity,
        )

        reg = self._reg()
        tracer = self.tracer
        with self._lock:
            step = self._step
            started = self._step_started
            hist = list(self._history)
        try:
            ident = process_identity()
        except ValueError:
            # a malformed identity env must not take down the dump —
            # the recorder's contract is that a post-mortem never
            # kills (or here: never silences) the run it observes
            ident = FleetIdentity(0, 1, None)
        payload = {
            "kind": "apex_tpu.flight_record",
            "schema_version": 1,
            **identity_fields(ident),
            "last_collective": fleet_probe.last_collective(),
            "last_collectives": {
                str(r): site
                for r, site in fleet_probe.last_collectives().items()},
            "reason": reason,
            "trigger": kind,
            "pid": os.getpid(),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "step": step,
            "step_elapsed_s": (None if started is None
                               else round(time.monotonic() - started, 3)),
            "step_history_s": [round(h, 4) for h in hist],
            "threshold_s": self.threshold_s(),
            "open_spans": {
                str(tid): [{"name": n, "age_s": round(age, 3)}
                           for n, age in frames]
                for tid, frames in tracer.open_spans().items()},
            "spans": [s.to_dict() for s in tracer.completed()],
            "thread_names": {str(k): v
                             for k, v in tracer.thread_names().items()},
            "thread_stacks": self._thread_stacks(),
            # a stall dump and an OOM memrec tell one coherent story:
            # current live bytes, watermark and the top buffers ride
            # every flight record (None when CUDA is not up or the read
            # fails; the section must never take down the dump)
            "memory": _memory_section(),
            "events": (reg.events()[-self.max_events:]
                       if self.max_events > 0 else []),
            "counters": {
                m.name + (str(sorted(m.labels.items()))
                          if m.labels else ""): m.value
                for m in reg.metrics() if m.kind == "counter"},
        }
        # rank + pid + per-process serial keep concurrent dumps (two
        # ranks sharing a fleet dir, or two watchdogs firing in the
        # same second of one process) from ever clobbering each other
        fname = (f"flightrec_{time.strftime('%Y%m%d-%H%M%S')}_"
                 f"r{ident.process_index}_{os.getpid()}_"
                 f"{next(_DUMP_SEQ)}_{kind}.json")
        path = os.path.join(self.directory, fname)
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=repr)
        except OSError as e:
            reg.counter("observability/flight_dump_failures").inc()
            reg.event("flight_dump_failed", reason=reason,
                      error=repr(e)[:200])
            return None
        reg.counter("observability/flight_dumps").inc()
        reg.event("flight_record", path=path, reason=reason, step=step)
        self.dumps.append(path)
        return path
