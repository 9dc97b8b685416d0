"""Functional FusedAdagrad (port of ``apex_tpu/optimizers/fused_adagrad.py``).

``fused_adagrad(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over nested dicts
of tensors: the accumulated squared gradients ``sum`` (fp32, a tree like
the params) and the step counter. L2 mode adds the weight decay to the
gradient before the accumulation, ``adagrad_w_mode`` to the update after
the division. Plain PyTorch leaf by leaf (:func:`_math.adagrad_step`),
as the JAX package runs it outside any Pallas kernel.
:class:`FusedAdagrad` is the stateful class (``fused_adagrad.py:52``).
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


class FusedAdagradState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    sum: Any  # fp32 accumulated squared gradients, a tree like params


def fused_adagrad(lr: ScalarOrSchedule = 1e-2, eps: float = 1e-10,
                  weight_decay: float = 0.0,
                  adagrad_w_mode: bool = False) -> GradientTransformation:
    """Functional FusedAdagrad; arguments mirror the JAX package's
    ``fused_adagrad`` (``fused_adagrad.py:24``)."""

    def init(params):
        h = _tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return FusedAdagradState(count=torch.zeros((), dtype=torch.int32),
                                 sum=h)

    def update(grads, state, params=None):
        """-> (updates, new state); updates in each param's dtype."""
        if params is None:
            raise ValueError("fused_adagrad requires params (for weight "
                             "decay)")
        # optax convention: the schedule sees the pre-increment count
        lr_t = _lr_at(lr, state.count)
        kw = dict(lr=lr_t, eps=eps, weight_decay=weight_decay,
                  adagrad_w_mode=adagrad_w_mode)
        deltas, sums = [], []
        for g, p, h in zip(_tree.leaves(grads), _tree.leaves(params),
                           _tree.leaves(state.sum)):
            delta, h = _math.adagrad_step(g, p, h, **kw)
            deltas.append(delta.to(p.dtype))
            sums.append(h)
        paths = _tree.paths(params)
        return (_tree.unflatten(paths, deltas),
                FusedAdagradState(count=state.count + 1,
                                  sum=_tree.unflatten(paths, sums)))

    return GradientTransformation(init, update)


class FusedAdagrad(FusedOptimizer):
    """Stateful Apex-style API (``fused_adagrad.py:52``)."""

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        del set_grad_none  # no .grad attributes: kept for API parity
        kw = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                  adagrad_w_mode=adagrad_w_mode)
        super().__init__(params, fused_adagrad(**kw),
                         dict(lr=lr, eps=eps, weight_decay=weight_decay),
                         tx_factory=lambda **ov: fused_adagrad(**{**kw,
                                                                  **ov}))
