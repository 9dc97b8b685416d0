"""Named trace scopes (port of ``apex_tpu/observability/scope.py``).

The reference enters ``jax.profiler.TraceAnnotation`` (the host
timeline) and ``jax.named_scope`` (the compiled program's op names).
The port enters ``torch.profiler.record_function(name)``, which names
the region on the host timeline of a ``torch.profiler`` trace (and in
its ``key_averages()``), and, once CUDA is initialised, an NVTX range
(``torch.cuda.nvtx.range_push``/``range_pop``), which names it on the
device timeline of a CUDA profiler. A trace then shows the reference's
names. Without an active profiler both cost a few microseconds.
"""

from __future__ import annotations

import contextlib
import functools

__all__ = ["scope", "annotate"]


@contextlib.contextmanager
def scope(name: str):
    """Open a named region on the host and device timelines."""
    import torch

    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """Decorator form: every call to the wrapped fn runs under
    :func:`scope(name)` (default: the function's qualname)."""
    def deco(fn):
        label = name or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with scope(label):
                return fn(*args, **kwargs)
        return wrapped
    return deco
