"""Gradient scaler with a model-parallel overflow vote (port of
``apex_tpu/transformer/amp/grad_scaler.py``).

The reference subclasses its :class:`LossScaler` and ORs the overflow
flag over the model-parallel mesh axes with ``pmax`` before the step is
taken or skipped: a rank that sees an overflow must make every tp and pp
rank skip, or the replicas diverge (CUDA Apex all-reduces ``found_inf``
with MAX over the model-parallel group). The port subclasses
:class:`apex_tpu_torch.amp.scaler.LossScaler` and MAX-reduces the flag
over the groups bound to those axis names; an axis with no group bound
is skipped, so the same scaler runs under any subset of the grid.
"""

from __future__ import annotations

from typing import Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.distributed import backend as _backend


class GradScaler(LossScaler):
    """ref grad_scaler.py:21. ``model_parallel_axes`` are the axes the
    overflow decision must agree across (tp and pp by default)."""

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000, enabled=True,
                 model_parallel_axes: Sequence[str] = ("tp", "pp")):
        super().__init__(
            loss_scale="dynamic", init_scale=init_scale,
            scale_factor=growth_factor, scale_window=growth_interval,
            enabled=enabled, backoff_factor=backoff_factor)
        self.model_parallel_axes = tuple(model_parallel_axes)

    def unscale(self, grads, state):
        unscaled, overflow = super().unscale(grads, state)
        if not self.enabled:
            return unscaled, overflow
        flag = overflow.to(torch.int32).reshape(1)
        for axis in self.model_parallel_axes:
            if _backend.is_bound(axis):
                flag = _backend.all_reduce(flag, _backend.ReduceOp.MAX, axis)
        return unscaled, flag[0] > 0
