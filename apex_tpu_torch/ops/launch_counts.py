"""The kernel wrappers' launch counters, read and moved as one.

Each wrapper adds one to a module counter where it launches its kernel,
and nowhere else. A CUDA graph replays its launches without calling the
wrappers, so the graph's runner (``serving.scheduler``) takes a
:func:`snapshot` around the capture, sets the counters back with
:func:`restore` (a capture launches nothing) and adds the capture's
:func:`delta` with :func:`add` on every replay: the counters keep
counting launches.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["COUNTERS", "add", "delta", "restore", "snapshot"]

# (module, its counters): every launch counter of the port's kernels
COUNTERS = (
    ("apex_tpu_torch.ops.flash_attention",
     ("launches", "dq_launches", "dkv_launches")),
    ("apex_tpu_torch.ops.layer_norm",
     ("launches", "bwd_launches", "ln_launches", "ln_bwd_launches")),
    ("apex_tpu_torch.ops.fused_adam_kernel", ("launches",)),
    ("apex_tpu_torch.ops.fp8_cast_kernel",
     ("launches", "col_launches", "fills")),
    ("apex_tpu_torch.transformer.functional.fused_softmax",
     ("causal_launches", "masked_launches", "stats_launches",
      "apply_launches")),
)

Counts = Dict[Tuple[str, str], int]


def snapshot() -> Counts:
    """Every counter's value, keyed by (module, name)."""
    out = {}
    for module, names in COUNTERS:
        mod = importlib.import_module(module)
        for name in names:
            out[(module, name)] = getattr(mod, name)
    return out


def delta(after: Counts, before: Counts) -> Counts:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def restore(counts: Counts) -> None:
    """Set the counters to ``counts`` (a :func:`snapshot`)."""
    for (module, name), value in counts.items():
        setattr(importlib.import_module(module), name, value)


def add(counts: Counts) -> None:
    """Add ``counts`` (a :func:`delta`) to the counters."""
    for (module, name), n in counts.items():
        mod = importlib.import_module(module)
        setattr(mod, name, getattr(mod, name) + n)
