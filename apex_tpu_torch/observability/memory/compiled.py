"""Per-graph static memory view (port of
``apex_tpu/observability/memory/compiled.py``).

The reference records XLA's ``memory_analysis()`` of every executable a
jitted function compiles. The port's executable is a captured CUDA
graph (:mod:`~apex_tpu_torch.observability.recompile`: the serving
decode step). Its footprint is measured, not modelled: the bytes its
private memory pool holds after capture, read from the CUDA caching
allocator (``torch.cuda.memory_snapshot()``, the segments whose
``segment_pool_id`` is the graph's pool). Per graph
(:func:`captured_graph_fields`):

- ``argument_bytes`` / ``output_bytes``: the graph's static inputs and
  outputs (a replay reads and writes them in place);
- ``temp_bytes``: the pool's bytes less the outputs (the intermediates'
  memory, reserved for every replay);
- ``alias_bytes``, ``generated_code_bytes``: None — the allocator gives
  no such number for a graph (never a fabricated 0);
- ``total_bytes`` = argument + output + temp, and ``pool_bytes``.

:class:`CompiledMemoryCapture` hooks the recompile listener as the
reference's does: a ``compile`` notification names the step, the
``backend_compile`` after it sweeps :func:`~apex_tpu_torch.observability.
recompile.live_graphs` for graphs not yet seen and records each one's
fields under that name, as a ``memory/compiled_total_bytes{fn=}`` gauge
and in the table ``MemoryMonitor.dump`` writes as ``compiled``.
:func:`memory_analysis_fields` keeps the reference's rule for an
analysis object that carries every field (None when one is missing).
The capture is an explicit switch (:func:`install_compiled_capture`).
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "COMPILED_STAT_FIELDS", "memory_analysis_fields",
    "captured_graph_fields", "CompiledMemoryCapture",
    "install_compiled_capture", "uninstall_compiled_capture",
    "current_capture",
]

#: the stats fields recorded per executable, in table order ("alias"
#: bytes are donation credit: argument bytes re-used as outputs).
COMPILED_STAT_FIELDS = (
    ("argument_size_in_bytes", "argument_bytes"),
    ("output_size_in_bytes", "output_bytes"),
    ("temp_size_in_bytes", "temp_bytes"),
    ("alias_size_in_bytes", "alias_bytes"),
    ("generated_code_size_in_bytes", "generated_code_bytes"),
)


def memory_analysis_fields(analysis) -> "dict | None":
    """An analysis object with the reference's attributes
    (``argument_size_in_bytes``, ...) as a plain dict (+ the derived
    ``total_bytes`` = argument + output + temp − alias). None when the
    analysis is None or lacks a field."""
    if analysis is None:
        return None
    out = {}
    for attr, key in COMPILED_STAT_FIELDS:
        value = getattr(analysis, attr, None)
        if value is None:
            return None
        out[key] = int(value)
    out["total_bytes"] = (out["argument_bytes"] + out["output_bytes"]
                          + out["temp_bytes"] - out["alias_bytes"])
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def captured_graph_fields(graph, inputs, outputs) -> dict:
    """The measured footprint of a captured ``torch.cuda.CUDAGraph``
    whose static inputs and outputs are ``inputs`` and ``outputs``
    (tensors); see the module doc."""
    import torch

    pool = tuple(graph.pool())
    pool_bytes = sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == pool)
    arg = _nbytes(inputs)
    out = _nbytes(outputs)
    temp = max(pool_bytes - out, 0)
    return {"argument_bytes": arg, "output_bytes": out,
            "temp_bytes": temp, "alias_bytes": None,
            "generated_code_bytes": None,
            "total_bytes": arg + out + temp, "pool_bytes": pool_bytes}


class CompiledMemoryCapture:
    """Collects per-graph memory fields; see module doc. Thread-safe:
    the recompile listener's observers fire from whatever thread
    captured or compiled."""

    def __init__(self, registry=None):
        self._registry = registry
        self._lock = threading.Lock()
        self._by_fn: dict = {}
        # graphs are keyed by id(): a graph alive at install is primed
        # as seen, so it is never attributed to the next compile
        self._seen: set = set()
        self._pending_fn: Optional[str] = None
        self._listener = None

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability.registry import get_registry
        return get_registry()

    # ---------------------------------------------------------- hooks

    def install(self) -> "CompiledMemoryCapture":
        """Attach to the (installed-if-needed) recompile listener; the
        graphs alive now are primed as seen."""
        from apex_tpu_torch.observability import recompile

        self._listener = recompile.install()
        with self._lock:
            self._seen.update(id(g) for g in recompile.live_graphs())
        self._listener.add_observer(self._observe)
        return self

    def uninstall(self) -> None:
        if self._listener is not None:
            self._listener.remove_observer(self._observe)
            self._listener = None

    def _observe(self, kind: str, name) -> None:
        if kind == "compile":
            with self._lock:
                self._pending_fn = name
        elif kind == "backend_compile":
            self.sweep()

    def sweep(self) -> int:
        """Record every live graph not yet seen, attributed to the last
        compile notification (``<unattributed>`` without one). Returns
        how many were recorded."""
        from apex_tpu_torch.observability import recompile

        graphs = recompile.live_graphs()
        with self._lock:
            fn_name = self._pending_fn or "<unattributed>"
            fresh = [g for g in graphs if id(g) not in self._seen]
            self._seen.update(id(g) for g in fresh)
            self._pending_fn = None
        for g in fresh:
            self.record(fn_name, g.compiled_memory_stats())
        return len(fresh)

    # --------------------------------------------------------- record

    def record(self, fn_name: str, fields: dict) -> dict:
        """Record one graph's fields under ``fn_name`` (latest wins;
        ``compiles`` counts how many landed)."""
        with self._lock:
            row = self._by_fn.setdefault(fn_name, {"compiles": 0})
            row["compiles"] += 1
            row.update(fields)
            snapshot = dict(row)
        reg = self._reg()
        reg.counter("memory/compiled_captures", fn=fn_name).inc()
        reg.gauge("memory/compiled_total_bytes", fn=fn_name).set(
            fields["total_bytes"])
        return snapshot

    def capture(self, fn, *args, name: Optional[str] = None, **kwargs):
        """Capture ``fn(*args, **kwargs)`` as a CUDA graph (one warm-up
        call on a side stream first) and record its fields under
        ``name``; returns ``(replay, fields)``, ``replay()`` replaying
        the graph and returning its static output. The explicit path
        for a step the runtime does not capture itself. Its tensors must
        lie on the card."""
        import torch

        name = name or getattr(fn, "__name__", "fn")
        inputs = [a for a in (*args, *kwargs.values())
                  if isinstance(a, torch.Tensor)]
        if not inputs or not all(t.is_cuda for t in inputs):
            raise ValueError(f"capturing {name} needs its tensors on a "
                             f"CUDA device")
        device = inputs[0].device
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn(*args, **kwargs)
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = fn(*args, **kwargs)
        outputs = [t for t in (out if isinstance(out, (tuple, list))
                               else (out,)) if isinstance(t, torch.Tensor)]
        fields = captured_graph_fields(graph, inputs, outputs)
        self.record(name, fields)

        def replay():
            graph.replay()
            return out

        return replay, fields

    # ----------------------------------------------------------- read

    def snapshot(self) -> dict:
        """{fn name: {compiles, argument/output/temp/alias/
        generated_code/total bytes, ...}} — the per-graph table."""
        with self._lock:
            return {name: dict(row)
                    for name, row in sorted(self._by_fn.items())}


# ------------------------------------------------------ process default

_CURRENT: "CompiledMemoryCapture | None" = None
_CURRENT_LOCK = threading.Lock()


def install_compiled_capture(registry=None) -> CompiledMemoryCapture:
    """Install (or return the already-installed) process capture —
    idempotent, like ``recompile.install``."""
    global _CURRENT
    with _CURRENT_LOCK:
        if _CURRENT is None:
            _CURRENT = CompiledMemoryCapture(registry=registry).install()
        elif registry is not None:
            _CURRENT._registry = registry
        return _CURRENT


def uninstall_compiled_capture() -> None:
    """Detach the process capture (its table stays readable)."""
    global _CURRENT
    with _CURRENT_LOCK:
        if _CURRENT is not None:
            _CURRENT.uninstall()
            _CURRENT = None


def current_capture() -> "CompiledMemoryCapture | None":
    return _CURRENT
