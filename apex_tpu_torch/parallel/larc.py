"""LARC (port of ``apex_tpu/parallel/larc.py``).

``larc(inner_tx, lr, ...)`` wraps an optimizer transform: before the
inner update every gradient leaf is rescaled by its layer-wise adaptive
rate, ``trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)``, with
``clip`` taken as ``min(rate / lr, 1)``; a leaf whose param or gradient
norm is 0 keeps scale 1, and the weight decay, when set, is added to the
gradient before the scale. ``lr`` is a float or a schedule of the
wrapper's own step count. :class:`LARC` wraps a :class:`FusedOptimizer`
(``LARC(FusedSGD(params, lr=0.1, momentum=0.9))``): it owns the weight
decay, so the inner transform is rebuilt with ``weight_decay=0``, and a
change of ``param_groups[0]["lr"]`` (or its weight decay) rebuilds both.
Plain PyTorch leaf by leaf, as the JAX package's ``jnp``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import GradientTransformation


class LARCState(NamedTuple):
    inner: Any  # the inner transform's state
    count: torch.Tensor  # int32 0-dim, on the CPU


def larc_scale(g, p, *, lr, trust_coefficient: float, clip: bool,
               eps: float, weight_decay: float):
    """One leaf's gradient after LARC (``larc.py:40`` ``rescale``), in
    the gradient's dtype; the rate's arithmetic is fp32."""
    g32 = g.float()
    p32 = p.float()
    p_norm = torch.sqrt(torch.sum(torch.square(p32)))
    g_norm = torch.sqrt(torch.sum(torch.square(g32)))
    adaptive_lr = trust_coefficient * p_norm / (
        g_norm + p_norm * weight_decay + eps)
    if clip:
        adaptive_lr = torch.clamp(adaptive_lr / lr, max=1.0)
    scale = torch.where((p_norm > 0) & (g_norm > 0), adaptive_lr,
                        torch.ones_like(adaptive_lr))
    if weight_decay:
        g32 = g32 + weight_decay * p32
    return (g32 * scale).to(g.dtype)


def larc(inner_tx, lr, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> GradientTransformation:
    """Wrap ``inner_tx`` with LARC's gradient rescaling (``larc.py:23``).
    ``lr`` is the inner optimizer's learning rate, a float or a schedule
    evaluated at this wrapper's count (before its increment), for the
    clipped form ``min(rate / lr, 1)``."""

    def init(params):
        return LARCState(inner=inner_tx.init(params),
                         count=torch.zeros((), dtype=torch.int32))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("larc requires params")
        lr_now = lr(state.count) if callable(lr) else lr
        g_leaves, treedef = _tree.flatten(grads)
        scaled = treedef.unflatten([
            larc_scale(g, p, lr=lr_now, trust_coefficient=trust_coefficient,
                       clip=clip, eps=eps, weight_decay=weight_decay)
            for g, p in zip(g_leaves, _tree.leaves(params))])
        updates, inner = inner_tx.update(scaled, state.inner, params)
        return updates, LARCState(inner=inner, count=state.count + 1)

    return GradientTransformation(init, update)


class LARC:
    """Apex-shaped wrapper over a :class:`FusedOptimizer`
    (``larc.py:64``): ``opt = LARC(FusedSGD(params, lr=0.1,
    momentum=0.9)); opt.step(grads)`` updates the params in place."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        lr = optimizer.defaults.get("lr", 1e-3)
        wd = optimizer.defaults.get("weight_decay", 0.0)
        # LARC owns the weight decay (it enters the rate's denominator and
        # is scaled with the gradient): the inner transform runs without
        inner_tx = optimizer.tx
        if wd and optimizer._tx_factory is not None:
            inner_tx = optimizer._tx_factory(weight_decay=0.0)
        self._inner_tx = inner_tx
        self._built_lr, self._built_wd = lr, wd
        self._tx = larc(inner_tx, lr=lr, trust_coefficient=trust_coefficient,
                        clip=clip, eps=eps, weight_decay=wd)
        self._state = LARCState(inner=optimizer.state,
                                count=torch.zeros((), dtype=torch.int32))

    def _refresh_hparams(self) -> None:
        """Honour a scheduler's poke of ``param_groups[0]["lr"]`` (or its
        weight decay): both are built into the transforms, so a change
        rebuilds them (``larc.py:92``)."""
        group = self.optim.param_groups[0] if self.optim.param_groups else {}
        lr = group.get("lr", self._built_lr)
        wd = group.get("weight_decay", self._built_wd)
        if lr == self._built_lr and wd == self._built_wd:
            return
        self._built_lr, self._built_wd = lr, wd
        if self.optim._tx_factory is not None:
            overrides = {"lr": lr}
            if wd:
                overrides["weight_decay"] = 0.0  # LARC owns weight decay
            self._inner_tx = self.optim._tx_factory(**overrides)
        self._tx = larc(self._inner_tx, lr=lr,
                        trust_coefficient=self.trust_coefficient,
                        clip=self.clip, eps=self.eps, weight_decay=wd)

    @property
    def params(self):
        return self.optim.params

    @property
    def state(self):
        return self._state

    @property
    def param_groups(self):
        """The wrapped optimizer's, so a scheduler's pokes reach LARC."""
        return self.optim.param_groups

    @param_groups.setter
    def param_groups(self, value):
        self.optim.param_groups = value

    @property
    def defaults(self):
        return self.optim.defaults

    def step(self, grads=None, closure=None):
        """One update in place; returns the params (or ``closure()``'s
        loss)."""
        loss = closure() if closure is not None else None
        if grads is None:
            raise ValueError("pass grads to step()")
        self._refresh_hparams()
        self._state = FusedOptimizer._update(self._tx, grads, self._state,
                                             self.optim.params)
        self.optim.state = self._state.inner
        return loss if loss is not None else self.optim.params

    def zero_grad(self, set_to_none: bool = True):  # noqa: ARG002 - parity
        return None

    def state_dict(self) -> dict:
        return self.optim.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optim.load_state_dict(state_dict)
        self._state = LARCState(inner=self.optim.state,
                                count=torch.zeros((), dtype=torch.int32))
