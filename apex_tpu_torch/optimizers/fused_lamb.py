"""Functional FusedLAMB (port of ``apex_tpu/optimizers/fused_lamb.py``).

``fused_lamb(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)``, over nested dicts of
tensors. One update: the global gradient norm (per-dtype
``multi_tensor_l2norm``s blended, as the reference splits fp16 and fp32
lists), clipping to ``max_grad_norm``, Adam-style moments and the raw
direction u, a per-tensor trust ratio ||p|| / ||u|| (gated by
``use_nvlamb``), and ``-lr * ratio * u`` in each param's dtype. Plain
PyTorch leaf by leaf, as the JAX package runs it outside any Pallas
kernel. :class:`FusedLAMB` is the stateful class (``fused_lamb.py:103``)
over it.

The step counter ``count`` is an int32 0-dim tensor on the CPU, as in
``fused_adam``; the norms and the clip coefficient stay on the params'
device, so an update never waits for it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.multi_tensor_apply import multi_tensor_l2norm
from apex_tpu_torch.optimizers import _math
from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    GradientTransformation,
    ScalarOrSchedule,
    _lr_at,
    opt_state_from_numpy,
)


class FusedLAMBState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    mu: Any  # fp32, a tree like params
    nu: Any


def fused_lamb(lr: ScalarOrSchedule = 1e-3, bias_correction: bool = True,
               betas=(0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.01, adam_w_mode: bool = True,
               grad_averaging: bool = True, max_grad_norm: float = 1.0,
               use_nvlamb: bool = False) -> GradientTransformation:
    """Functional FusedLAMB; arguments mirror the JAX package's
    ``fused_lamb`` (``fused_lamb.py:34``)."""
    b1, b2 = betas

    def init(params):
        mu = _tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return FusedLAMBState(count=torch.zeros((), dtype=torch.int32),
                              mu=mu, nu=_tree.map_leaves(torch.zeros_like,
                                                         mu))

    def update(grads, state, params=None):
        """-> (updates, new state); updates in each param's dtype."""
        if params is None:
            raise ValueError("fused_lamb requires params (for the trust "
                             "ratio and weight decay)")
        count = state.count + 1
        step = count.to(torch.float32)
        # optax convention: the schedule sees the pre-increment count
        lr_t = _lr_at(lr, state.count)
        g_leaves = _tree.leaves(grads)
        by_dtype: dict = {}
        for g in g_leaves:
            by_dtype.setdefault(g.dtype, []).append(g)
        norms = [multi_tensor_l2norm(ls)[0] for ls in by_dtype.values()]
        gnorm = torch.sqrt(sum(torch.square(n) for n in norms))
        # max_grad_norm <= 0 disables clipping (fused_lamb.py:75)
        if max_grad_norm > 0.0:
            clip_coeff = torch.where(
                gnorm > max_grad_norm,
                max_grad_norm / torch.clamp(gnorm, min=1e-30),
                torch.ones_like(gnorm))
        else:
            clip_coeff = torch.ones_like(gnorm)

        def leaf(g, p, m, v):
            m, v = _math.lamb_moments(
                g, p, m, v, b1=b1, b2=b2, grad_averaging=grad_averaging,
                clip_coeff=clip_coeff, weight_decay=weight_decay,
                adam_w_mode=adam_w_mode)
            u = _math.lamb_update_direction(
                p, m, v, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                adam_w_mode=adam_w_mode, step=step,
                bias_correction=bias_correction)
            p_norm = torch.sqrt(torch.sum(torch.square(p.float())))
            u_norm = torch.sqrt(torch.sum(torch.square(u)))
            ratio = _math.lamb_trust_ratio(p_norm, u_norm,
                                           weight_decay=weight_decay,
                                           use_nvlamb=use_nvlamb)
            return (-lr_t * ratio * u).to(p.dtype), m, v

        results = [leaf(g, p, m, v) for g, p, m, v in zip(
            g_leaves, _tree.leaves(params), _tree.leaves(state.mu),
            _tree.leaves(state.nu))]
        paths = _tree.paths(params)
        return (_tree.unflatten(paths, [r[0] for r in results]),
                FusedLAMBState(
                    count=count,
                    mu=_tree.unflatten(paths, [r[1] for r in results]),
                    nu=_tree.unflatten(paths, [r[2] for r in results])))

    return GradientTransformation(init, update)


class FusedLAMB(FusedOptimizer):
    """Stateful Apex-style API (``fused_lamb.py:103``)."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        del set_grad_none
        kw = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                  eps=eps, weight_decay=weight_decay,
                  adam_w_mode=adam_w_mode, grad_averaging=grad_averaging,
                  max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
        super().__init__(params, fused_lamb(**kw), dict(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm),
            tx_factory=lambda **ov: fused_lamb(**{**kw, **ov}))
