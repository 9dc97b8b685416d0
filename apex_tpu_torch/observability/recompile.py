"""Runtime compile/retrace accounting (port of
``apex_tpu/observability/recompile.py``).

The reference counts what XLA compiles (``jax.monitoring`` events and
the ``jax_log_compiles`` records) and turns the count into a budget a
run can fail on. The port compiles two kinds of thing, and the listener
counts both under one per-function table:

- **a CUDA-graph capture**: the serving decode step
  (``serving/scheduler.py``'s ``DecodeGraph``), captured once per
  scheduler at its first decode step on the card and replayed after.
  It is the counterpart of the reference's jitted ``_decode_step``, and
  the capture reports itself under that name (:func:`note_capture`): one
  ``compile`` of ``_decode_step`` and, the graph built, one
  ``backend_compile`` with the capture's seconds. A second capture of
  the same graph is a retrace; another scheduler's first capture of its
  own graph is a compile of ``_decode_step`` but no retrace (each graph
  is its own origin, as each jitted function object is in the
  reference's cache). On a CPU device the step runs eagerly and nothing
  is captured.
- **a** ``torch._dynamo`` **compile** (``torch.compile``), through
  dynamo's own compile callbacks: the start of a dynamo compile of a
  frame is a ``compile`` of the frame's function (its code name), the
  end a ``backend_compile`` with the seconds between them; a frame
  compiled again (a guard failed) is a retrace. No path of the port
  calls ``torch.compile``, and :func:`install` imports no part of
  dynamo: its callbacks are registered when ``torch._dynamo`` is first
  imported, before which no dynamo compile can start.

The listener is an explicit switch (:func:`install`), off by default.
The graphs captured while it is off are still known to
:func:`live_graphs`, as XLA's live executables are, for the compiled
memory capture (:mod:`~apex_tpu_torch.observability.memory.compiled`).

Counts also land in a :class:`~apex_tpu_torch.observability.registry
.MetricRegistry`: counter ``torch/compiles{fn=...}``, histogram
``torch/backend_compile_secs``, counter ``torch/guarded_retraces``.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.abc
import importlib.util
import itertools
import sys
import threading
import time
import weakref

from apex_tpu_torch.observability.registry import get_registry

__all__ = [
    "RecompileListener", "RetraceBudgetExceeded", "install", "uninstall",
    "current", "retrace_guard", "note_capture", "live_graphs",
]

_EV_TRACE = "trace"                  # a compile started (name known)
_EV_COMPILE = "backend_compile"      # a graph or executable exists
_DYNAMO_CALLBACKS = "torch._dynamo.callback"

# each capturing object's serial: its captures' origin (an id could be
# reused by a later object once the first is gone)
_SERIALS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_NEXT_SERIAL = itertools.count(1)


def _origin(source):
    """The origin a compile is counted under: None for a compile with no
    capturing object (dynamo's: one origin a function), else the
    object's serial."""
    if source is None:
        return None
    try:
        serial = _SERIALS.get(source)
        if serial is None:
            serial = _SERIALS[source] = next(_NEXT_SERIAL)
        return serial
    except TypeError:    # not weakly referenceable
        return ("id", id(source))


class RetraceBudgetExceeded(RuntimeError):
    """A guarded region retraced more than its budget allows."""


class RecompileListener:
    """Aggregates compile activity while installed; see module doc."""

    def __init__(self, registry=None):
        self.registry = registry
        self._lock = threading.Lock()
        self.compiles_by_fn = collections.Counter()
        # (fn name, origin) -> compiles: one scheduler's graph apart
        # from another's of the same step; a retrace is a compile
        # beyond the first of its origin
        self._by_origin = collections.Counter()
        self.totals = collections.Counter()      # event name -> count
        self.seconds = collections.defaultdict(float)
        # compile observers: callbacks cb(kind, name) fired on "compile"
        # (name known, graph not yet built) and "backend_compile" (the
        # graph exists: the moment the memory tier sweeps the live
        # graphs)
        self._observers: list = []
        self.observer_errors = 0

    # ---- feeds

    def _on_compile_record(self, fn_name: str, source=None) -> None:
        with self._lock:
            self.compiles_by_fn[fn_name] += 1
            self.totals[_EV_TRACE] += 1
            self._by_origin[(fn_name, _origin(source))] += 1
        if self.registry is not None:
            self.registry.counter("torch/compiles", fn=fn_name).inc()
        self._notify("compile", fn_name)

    def _on_backend_compile(self, secs: float) -> None:
        with self._lock:
            self.totals[_EV_COMPILE] += 1
            self.seconds[_EV_COMPILE] += secs
        if self.registry is not None:
            self.registry.histogram("torch/backend_compile_secs").observe(
                secs)
        self._notify("backend_compile", None)

    # ---- compile observers

    def add_observer(self, cb) -> None:
        """Register ``cb(kind, name)`` to fire on compile activity
        (``kind`` in {"compile", "backend_compile"}); idempotent."""
        with self._lock:
            if cb not in self._observers:
                self._observers.append(cb)

    def remove_observer(self, cb) -> None:
        with self._lock:
            if cb in self._observers:
                self._observers.remove(cb)

    def _notify(self, kind: str, name) -> None:
        with self._lock:
            observers = list(self._observers)
        for cb in observers:
            try:
                cb(kind, name)
            except Exception:  # noqa: BLE001 — an observer must never
                # break the compile it rides
                with self._lock:
                    self.observer_errors += 1

    # ---- read side

    def compiles(self, fn: "str | None" = None, source=None):
        """Per-function compile counts (dict), or one function's count;
        with ``source``, the count of that function's captures
        :func:`note_capture` reported from ``source`` alone (a
        scheduler's own decode graph)."""
        with self._lock:
            if source is not None:
                return self._by_origin.get((fn, _origin(source)), 0)
            if fn is not None:
                return self.compiles_by_fn.get(fn, 0)
            return dict(self.compiles_by_fn)

    def _retrace_table(self) -> dict:
        table: dict = {}
        for (name, _), n in self._by_origin.items():
            if n > 1:
                table[name] = table.get(name, 0) + n - 1
        return table

    def retraces(self, fn: "str | None" = None):
        """Compiles beyond the first per function and origin — the
        recompiles a steady-state loop should never see."""
        with self._lock:
            table = self._retrace_table()
            if fn is not None:
                return table.get(fn, 0)
            return table

    def total_retraces(self) -> int:
        return sum(self.retraces().values())

    def backend_compiles(self) -> int:
        """Process-total finished compiles (captures and dynamo
        compiles)."""
        with self._lock:
            return self.totals[_EV_COMPILE]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "compiles_by_fn": dict(self.compiles_by_fn),
                "retraces_by_fn": self._retrace_table(),
                "backend_compiles": self.totals[_EV_COMPILE],
                "backend_compile_secs": round(
                    self.seconds[_EV_COMPILE], 3),
                "trace_events": self.totals[_EV_TRACE],
            }


class _State:
    def __init__(self):
        self.listener: "RecompileListener | None" = None
        self.dynamo_registered = False
        self.dynamo_started: dict = {}   # compile id -> perf_counter
        self.graphs: list = []           # weakrefs to captured graphs
        self.lock = threading.Lock()


_STATE = _State()


def _dynamo_frame_name() -> "str | None":
    """The code name of the frame dynamo is compiling: its compile loop
    holds the frame's code object in a local named ``code``."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_locals.get("code")
        if (frame.f_code.co_name in ("compile_inner", "_compile")
                and hasattr(code, "co_name")):
            return code.co_name
        frame = frame.f_back
    return None


def _dynamo_start(args) -> None:
    listener = _STATE.listener
    if listener is None or args.callback_trigger.name != "DYNAMO":
        return
    with _STATE.lock:
        _STATE.dynamo_started[args.compile_id] = time.perf_counter()
    # the frame id names the frame when its code name cannot be read
    name = _dynamo_frame_name() or (
        f"dynamo_frame{str(args.compile_id).split('/')[0]}")
    listener._on_compile_record(name)


def _dynamo_end(args) -> None:
    listener = _STATE.listener
    with _STATE.lock:
        started = _STATE.dynamo_started.pop(args.compile_id, None)
    if listener is None or started is None:
        return
    listener._on_backend_compile(time.perf_counter() - started)


def _register_dynamo(module) -> None:
    module.callback_handler.register_start_callback(_dynamo_start)
    module.callback_handler.register_end_callback(_dynamo_end)


class _DynamoImportHook(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Registers the dynamo callbacks once ``torch._dynamo.callback`` has
    been imported (``torch.compile`` imports it before its first
    compile), so that a process that never compiles never imports
    dynamo. It takes itself off ``sys.meta_path`` at that import."""

    def find_spec(self, fullname, path, target=None):
        if fullname != _DYNAMO_CALLBACKS:
            return None
        if self in sys.meta_path:
            sys.meta_path.remove(self)
        spec = importlib.util.find_spec(fullname)
        if spec is None or spec.loader is None:
            return spec
        self._loader = spec.loader
        spec.loader = self
        return spec

    def create_module(self, spec):
        return self._loader.create_module(spec)

    def exec_module(self, module):
        module.__loader__ = module.__spec__.loader = self._loader
        self._loader.exec_module(module)
        _register_dynamo(module)


def install(registry=None) -> RecompileListener:
    """Install (or return the already-installed) process listener.

    Idempotent: repeated calls return the same listener (updating its
    registry only if one is passed). dynamo's callbacks are registered
    once per process (when dynamo is imported, if it is not yet) and
    routed through the module state, so after :func:`uninstall` they go
    inert rather than away."""
    with _STATE.lock:
        if _STATE.listener is not None:
            if registry is not None:
                _STATE.listener.registry = registry
            return _STATE.listener
        listener = RecompileListener(
            registry if registry is not None else get_registry())
        if not _STATE.dynamo_registered:
            _STATE.dynamo_registered = True
            module = sys.modules.get(_DYNAMO_CALLBACKS)
            if module is not None:
                _register_dynamo(module)
            else:
                sys.meta_path.insert(0, _DynamoImportHook())
        _STATE.listener = listener
        return listener


def uninstall() -> None:
    """Deactivate the listener. Counts on the listener :func:`install`
    returned stop growing but remain readable."""
    with _STATE.lock:
        _STATE.listener = None
        _STATE.dynamo_started.clear()


def current() -> "RecompileListener | None":
    return _STATE.listener


def note_capture(name: str, graph, seconds: float) -> None:
    """Report one finished CUDA-graph capture of the step ``name``:
    ``graph`` joins :func:`live_graphs`, and the listener, when one is
    installed, counts a compile of ``name`` and a backend compile of
    ``seconds``. ``graph`` is an object with a
    ``compiled_memory_stats()`` method (the decode graph's)."""
    with _STATE.lock:
        _STATE.graphs = [r for r in _STATE.graphs if r() is not None]
        _STATE.graphs.append(weakref.ref(graph))
        listener = _STATE.listener
    if listener is not None:
        listener._on_compile_record(name, source=graph)
        listener._on_backend_compile(seconds)


def live_graphs() -> list:
    """The captured graphs still alive, oldest first."""
    with _STATE.lock:
        alive = [r() for r in _STATE.graphs]
    return [g for g in alive if g is not None]


@contextlib.contextmanager
def retrace_guard(budget: int = 0, registry=None, fns=None):
    """Fail a region that retraces more than ``budget`` times.

    Wrap a loop and any steady-state retrace beyond the budget raises
    :class:`RetraceBudgetExceeded` naming the offending functions.
    First compiles are free — only compiles of a function already
    compiled once inside OR before the region count, from the same
    origin: a capture again of one graph counts, the first capture of
    another scheduler's graph does not.

        with retrace_guard(budget=0, fns=["_decode_step"]):
            engine.run()        # the decode graph must not be captured again

    ``fns``: optional iterable of function names to watch; other names
    are ignored.
    """
    listener = install(registry=registry)
    watch = None if fns is None else set(fns)
    before = listener.retraces()
    yield listener
    retraced = {}
    for fn_name, n in listener.retraces().items():
        if watch is not None and fn_name not in watch:
            continue
        # retraces in-region: compiles beyond each origin's first-ever
        if n > before.get(fn_name, 0):
            retraced[fn_name] = n - before.get(fn_name, 0)
    total = sum(retraced.values())
    if registry is not None or listener.registry is not None:
        reg = registry if registry is not None else listener.registry
        reg.counter("torch/guarded_retraces").inc(total)
    if total > budget:
        raise RetraceBudgetExceeded(
            f"{total} retrace(s) exceed budget {budget}: " + ", ".join(
                f"{name} x{n}" for name, n in sorted(retraced.items())))
