"""Functional FusedMixedPrecisionLamb (port of
``apex_tpu/optimizers/fused_mixed_precision_lamb.py``).

The fp32 master params live in the optimizer's state
(``FusedMPLambState(master, inner)``, ``inner`` the ``fused_lamb`` state
over the masters). An update casts the gradients to fp32, runs LAMB on
the masters, adds its deltas to them, and returns the model's update in
the model's dtype as the reference forms it: ``round(master) - p``,
computed in that dtype. Applied as ``p + (round(master) - p)`` (what
:class:`FusedOptimizer` does in place), a bf16 param can land one
rounding away from ``round(master)``, as in the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import (
    GradientTransformation,
    ScalarOrSchedule,
)
from apex_tpu_torch.optimizers.fused_lamb import fused_lamb


class FusedMPLambState(NamedTuple):
    master: Any  # fp32 master params, a tree like params
    inner: Any  # the FusedLAMBState over the masters


def fused_mixed_precision_lamb(
        lr: ScalarOrSchedule = 1e-3, bias_correction: bool = True,
        betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.01,
        adam_w_mode: bool = True, grad_averaging: bool = True,
        max_grad_norm: float = 1.0, use_nvlamb: bool = False,
        reduced_precision_dtype=None) -> GradientTransformation:
    """Functional FusedMixedPrecisionLamb; arguments mirror the JAX
    package's (``fused_mixed_precision_lamb.py:30``). The model's dtype
    is whatever the params carry, so ``reduced_precision_dtype`` is
    accepted and ignored, as there."""
    del reduced_precision_dtype
    inner_tx = fused_lamb(lr=lr, bias_correction=bias_correction,
                          betas=betas, eps=eps, weight_decay=weight_decay,
                          adam_w_mode=adam_w_mode,
                          grad_averaging=grad_averaging,
                          max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)

    def init(params):
        # a copy even where a param is fp32 already: the masters are
        # updated in place and must not alias the model
        master = _tree.map_leaves(
            lambda p: p.detach().to(torch.float32, copy=True), params)
        return FusedMPLambState(master=master, inner=inner_tx.init(master))

    def update(grads, state, params=None):
        """-> (updates in each param's dtype, new state)."""
        if params is None:
            raise ValueError("fused_mixed_precision_lamb requires params")
        g32 = _tree.map_leaves(lambda g: g.float(), grads)
        deltas, inner = inner_tx.update(g32, state.inner, state.master)
        paths = _tree.paths(params)
        masters, updates = [], []
        for m, d, p in zip(_tree.leaves(state.master), _tree.leaves(deltas),
                           _tree.leaves(params)):
            m = m + d
            masters.append(m)
            updates.append(m.to(p.dtype) - p)
        return (_tree.unflatten(paths, updates),
                FusedMPLambState(master=_tree.unflatten(paths, masters),
                                 inner=inner))

    return GradientTransformation(init, update)


class FusedMixedPrecisionLamb(FusedOptimizer):
    """Stateful Apex-style API
    (``fused_mixed_precision_lamb.py:64``)."""

    def __init__(self, params, lr=1e-3, step=0, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 max_grad_norm=1.0, use_nvlamb=False,
                 reduced_precision_dtype=None):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        del step
        tx = fused_mixed_precision_lamb(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            grad_averaging=grad_averaging, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb,
            reduced_precision_dtype=reduced_precision_dtype)
        super().__init__(params, tx, dict(lr=lr, betas=betas, eps=eps,
                                          weight_decay=weight_decay))
