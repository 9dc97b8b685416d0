"""Functional FusedSGD (port of ``apex_tpu/optimizers/fused_sgd.py``).

``fused_sgd(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)``: momentum,
dampening, nesterov and weight decay as ``torch.optim.SGD`` has them,
plus the reference's ``wd_after_momentum``. The first update seeds each
momentum buffer with its raw gradient. Plain PyTorch leaf by leaf
(:func:`_math.sgd_step`), as the JAX package's update is per-leaf ``jnp``:
the reference has no kernel for it. :class:`FusedSGD` is the stateful
class (``fused_sgd.py:76``) over it; ``materialize_master_grads`` and
``set_grad_none`` are accepted and ignored (amp keeps the master
weights).

The step counter ``count`` is an int32 0-dim tensor on the CPU, as in
``fused_adam``: whether this is the first update, and a schedule's
learning rate, are read from it on the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers import _math
from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import (
    GradientTransformation,
    ScalarOrSchedule,
    _lr_at,
)


class FusedSGDState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    momentum_buffer: Any  # fp32, a tree like params


def fused_sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False,
              wd_after_momentum: bool = False) -> GradientTransformation:
    """Functional FusedSGD; arguments mirror the JAX package's
    ``fused_sgd`` (``fused_sgd.py:28``)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("Nesterov momentum requires a momentum and zero "
                         "dampening")

    def init(params):
        buf = _tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return FusedSGDState(count=torch.zeros((), dtype=torch.int32),
                             momentum_buffer=buf)

    def update(grads, state, params=None):
        """-> (updates, new state); updates in each param's dtype."""
        if params is None:
            raise ValueError("fused_sgd requires params (for weight "
                             "decay)")
        # optax convention: the schedule sees the pre-increment count
        lr_t = _lr_at(lr, state.count)
        kw = dict(lr=lr_t, momentum=momentum, dampening=dampening,
                  nesterov=nesterov, weight_decay=weight_decay,
                  wd_after_momentum=wd_after_momentum,
                  first_run=int(state.count) == 0)
        deltas, bufs = [], []
        for g, p, b in zip(_tree.leaves(grads), _tree.leaves(params),
                           _tree.leaves(state.momentum_buffer)):
            delta, b = _math.sgd_step(g, p, b, **kw)
            deltas.append(delta.to(p.dtype))
            bufs.append(b)
        paths = _tree.paths(params)
        return (_tree.unflatten(paths, deltas),
                FusedSGDState(count=state.count + 1,
                              momentum_buffer=_tree.unflatten(paths, bufs)))

    return GradientTransformation(init, update)


class FusedSGD(FusedOptimizer):
    """Stateful Apex-style API (``fused_sgd.py:76``)."""

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False):
        del materialize_master_grads, set_grad_none
        kw = dict(lr=lr, momentum=momentum, dampening=dampening,
                  weight_decay=weight_decay, nesterov=nesterov,
                  wd_after_momentum=wd_after_momentum)
        super().__init__(params, fused_sgd(**kw), dict(
            lr=lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=nesterov),
            tx_factory=lambda **ov: fused_sgd(**{**kw, **ov}))
