"""Functional FusedNovoGrad (port of
``apex_tpu/optimizers/fused_novograd.py``).

``fused_novograd(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over nested dicts
of tensors. The first moment ``mu`` is fp32, a tree like the params; the
second is ``v_norm``, one fp32 0-dim tensor a leaf: the EMA of the
gradient's norm (L2 for ``norm_type`` 2, Linf for 0), not of its square
(:func:`_math.novograd_step`). With ``init_zero=False`` the first update
(``count == 0``, read on the host) seeds it with that step's norm, so
the first blend leaves it there. Plain PyTorch leaf by leaf, as the JAX
package runs it outside any Pallas kernel. :class:`FusedNovoGrad` is the
stateful class (``fused_novograd.py:86``).
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


class FusedNovoGradState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    mu: Any  # fp32, a tree like params
    v_norm: Any  # fp32 0-dim a leaf: the norm's EMA


def _grad_norm(g, norm_type: int):
    g32 = g.float()
    if norm_type == 0:
        return torch.amax(torch.abs(g32))
    return torch.sqrt(torch.sum(torch.square(g32)))


def fused_novograd(lr: ScalarOrSchedule = 1e-3, bias_correction: bool = True,
                   betas=(0.95, 0.98), eps: float = 1e-8,
                   weight_decay: float = 0.0, grad_averaging: bool = True,
                   reg_inside_moment: bool = False, norm_type: int = 2,
                   init_zero: bool = False) -> GradientTransformation:
    """Functional FusedNovoGrad; arguments mirror the JAX package's
    ``fused_novograd`` (``fused_novograd.py:30``)."""
    if norm_type not in (0, 2):
        raise RuntimeError("FusedNovoGrad only support l2/inf norm now.")
    b1, b2 = betas

    def init(params):
        mu = _tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        v = _tree.map_leaves(
            lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
            params)
        return FusedNovoGradState(count=torch.zeros((), dtype=torch.int32),
                                  mu=mu, v_norm=v)

    def update(grads, state, params=None):
        """-> (updates, new state); updates in each param's dtype."""
        if params is None:
            raise ValueError("fused_novograd requires params (for weight "
                             "decay)")
        count = state.count + 1
        step = count.to(torch.float32)
        # optax convention: the schedule sees the pre-increment count
        lr_t = _lr_at(lr, state.count)
        seed = not init_zero and int(state.count) == 0
        deltas, mus, vs = [], [], []
        for g, p, m, v in zip(_tree.leaves(grads), _tree.leaves(params),
                              _tree.leaves(state.mu),
                              _tree.leaves(state.v_norm)):
            if seed:  # the first blend of the norm with itself
                v = _grad_norm(g, norm_type)
            delta, m, v = _math.novograd_step(
                g, p, m, v, lr=lr_t, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, grad_averaging=grad_averaging,
                reg_inside_moment=reg_inside_moment, step=step,
                bias_correction=bias_correction, norm_type=norm_type)
            deltas.append(delta.to(p.dtype))
            mus.append(m)
            vs.append(v)
        paths = _tree.paths(params)
        return (_tree.unflatten(paths, deltas),
                FusedNovoGradState(count=count,
                                   mu=_tree.unflatten(paths, mus),
                                   v_norm=_tree.unflatten(paths, vs)))

    return GradientTransformation(init, update)


class FusedNovoGrad(FusedOptimizer):
    """Stateful Apex-style API (``fused_novograd.py:86``)."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        del set_grad_none  # no .grad attributes: kept for API parity
        kw = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                  eps=eps, weight_decay=weight_decay,
                  grad_averaging=grad_averaging,
                  reg_inside_moment=reg_inside_moment, norm_type=norm_type,
                  init_zero=init_zero)
        super().__init__(params, fused_novograd(**kw), dict(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay),
            tx_factory=lambda **ov: fused_novograd(**{**kw, **ov}))
