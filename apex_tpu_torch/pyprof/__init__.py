"""The reference-named profiling shim (port of ``apex_tpu/pyprof``).

It keeps the ``apex.pyprof`` API names (``init``, ``start``, ``stop``,
``nvtx.range_push/pop``, ``annotate``, ``wrap``) so reference-style
instrumentation ports unchanged, and hosts the trace parser and report
(:mod:`~apex_tpu_torch.pyprof.parse`, :mod:`~apex_tpu_torch.pyprof.prof`)
that :mod:`apex_tpu_torch.observability.profiling.xplane` consumes:

- ``init(trace_dir=...)``, ``start()``, ``stop()`` run one
  ``torch.profiler`` window (the host's ops, and the card's kernels,
  copies and fills when CUDA is available). ``start()`` opens
  ``ProfilerStep#1`` and ``step()`` closes the current step and opens
  the next (the ``ProfilerStep#N`` annotations are the counterpart of
  the reference's device ``Steps`` line; call ``step()`` between steps,
  not after the last). ``stop()`` writes the window as a Chrome-trace
  JSON under ``trace_dir`` and returns its path. ``start()`` first runs
  the profiler through one warm-up step whose records are dropped (the
  profiler's own ``WARMUP`` action) and launches :data:`PRIME_KERNELS`
  trivial kernels on the card in it: on an H100 (torch 2.11) the
  records of the first kernels of a recording were lost (3–39 of them,
  their launch calls recorded) unless a warm-up with kernels came
  first;
- ``annotate``/``wrap``/``nvtx`` delegate to
  :func:`apex_tpu_torch.observability.profiling.span` (the span ring, a
  ``record_function`` range and, once CUDA is up, an NVTX range);
- ``python -m apex_tpu_torch.pyprof <trace>`` prints the per-op,
  per-category and per-phase report of a trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import tempfile
import time
from typing import Optional

from apex_tpu_torch.pyprof import parse, prof  # noqa: F401 (re-export)
from apex_tpu_torch.pyprof.prof import Report  # noqa: F401

__all__ = ["init", "start", "step", "stop", "nvtx", "annotate", "wrap",
           "Report", "parse", "prof", "PRIME_KERNELS"]

#: kernels launched in the warm-up step, whose records are dropped
PRIME_KERNELS = 64

_enabled = False
_trace_dir: Optional[str] = None
_profiler = None
_written: list = []


def init(enable_trace: bool = True, trace_dir: Optional[str] = None):
    """ref apex/pyprof/nvtx/nvmarker.py init: arm the trace window.
    ``trace_dir`` defaults to ``apex_tpu_torch_trace`` under the
    temporary directory."""
    global _enabled, _trace_dir
    _enabled = enable_trace
    _trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                           "apex_tpu_torch_trace")


def _export(profiler) -> None:
    os.makedirs(_trace_dir, exist_ok=True)
    path = os.path.join(
        _trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                    f"{time.time_ns()}.pt.trace.json")
    profiler.export_chrome_trace(path)
    _written.append(path)


def _warm_up_then_record(step: int):
    from torch.profiler import ProfilerAction

    return ProfilerAction.WARMUP if step == 0 else ProfilerAction.RECORD


def start():
    """Begin a trace window (the analog of cuda profiler start)."""
    global _profiler
    if not (_enabled and _trace_dir) or _profiler is not None:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    _profiler = profile(activities=activities, schedule=_warm_up_then_record,
                        on_trace_ready=_export)
    _profiler.start()
    if cuda:
        prime = torch.zeros(1, dtype=torch.int16, device="cuda")
        for _ in range(PRIME_KERNELS):
            prime.add_(1)
        torch.cuda.synchronize()
    _profiler.step()


def step():
    """Close the current ``ProfilerStep#N`` and open the next."""
    if _profiler is not None:
        _profiler.step()


def stop() -> Optional[str]:
    """End the window; the path of the trace it wrote (None when no
    window was open)."""
    global _profiler
    if _profiler is None:
        return None
    profiler, _profiler = _profiler, None
    before = len(_written)
    profiler.stop()
    return _written[-1] if len(_written) > before else None


class nvtx:
    """nvtx-shaped annotation API; ranges become spans on every
    timeline (ring buffer, ``record_function``, NVTX)."""

    _stack = []

    @staticmethod
    def range_push(name: str):
        from apex_tpu_torch.observability.profiling.spans import span

        # the push/pop pair IS the reference nvtx API — the stack
        # guarantees the close that a `with` would
        ctx = span(name)  # apex-lint: disable=unclosed-span
        ctx.__enter__()
        nvtx._stack.append(ctx)

    @staticmethod
    def range_pop():
        if nvtx._stack:
            nvtx._stack.pop().__exit__(None, None, None)


@contextlib.contextmanager
def annotate(name: str):
    from apex_tpu_torch.observability.profiling.spans import span

    with span(name):
        yield


def wrap(fn, name: Optional[str] = None):
    """Decorate ``fn`` so every call is an annotated range (ref pyprof wraps
    torch functions module-wide; explicit opt-in here)."""
    from apex_tpu_torch.observability.profiling.spans import span

    label = name or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with span(label):
            return fn(*a, **kw)

    return wrapped
