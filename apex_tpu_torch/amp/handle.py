"""AmpHandle and ``scale_loss`` (port of ``apex_tpu/amp/handle.py``).

The handle carries the dtype :class:`~.frontend.Policy`, the
:class:`~.scaler.LossScaler` and its state, and (O4) the fp8 scaler and
its state. Two protocols, as in the reference:

- functional: ``scaled = handle.scale(loss, sstate)``, the grads of
  ``scaled``, then ``updates, opt_state, sstate, overflow =
  handle.scaled_update(tx, grads, opt_state, params, sstate)``;
- stateful, Apex's: ``with handle.scale_loss(loss) as scaled:``, the
  grads of ``scaled``, then ``opt.step(grads)`` on an optimizer that
  :meth:`AmpHandle.attach` patched to unscale, skip on overflow, move the
  loss scale and (O2, O4) keep fp32 master weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp.frontend import Policy, Properties
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.amp.scaler import scaled_update as _scaled_update
from apex_tpu_torch.optimizers._base import _apply_updates


class AmpHandle:
    def __init__(self, props: Properties, min_loss_scale=None,
                 max_loss_scale=2.0 ** 24, half_dtype=torch.bfloat16):
        self.props = props
        compute = (half_dtype if props.opt_level in ("O1", "O2", "O3", "O4")
                   else torch.float32)
        self.policy = Policy(
            param_dtype=props.cast_model_type or torch.float32,
            compute_dtype=compute if props.enabled else torch.float32,
            output_dtype=torch.float32,
            keep_batchnorm_fp32=(bool(props.keep_batchnorm_fp32)
                                 if props.keep_batchnorm_fp32 is not None
                                 else True))
        self.scaler = LossScaler(
            loss_scale=props.loss_scale if props.enabled else 1.0,
            min_loss_scale=min_loss_scale, max_loss_scale=max_loss_scale,
            enabled=props.enabled and props.loss_scale != 1.0)
        self.scaler_state = self.scaler.init()
        self._optimizers = []
        # O4: the fp8 scaler's sites depend on the step, so init_fp8 binds
        # it later; until then state_dict() carries no "fp8" block
        self.fp8_enabled = bool(props.fp8)
        self.fp8_scaler = None
        self.fp8_state = None

    # ---- fp8 tier (O4) -----------------------------------------------

    def init_fp8(self, sites, history: int = 16, margin: float = 0.0,
                 device=None):
        """Bind the O4 delayed-scaling automaton to ``sites`` (the
        ``matmul_amp`` site names) with fresh rings on ``device`` (default:
        the GPU). Returns the
        :class:`~apex_tpu_torch.amp.scaler.Fp8DelayedScaler`; its state is
        ``handle.fp8_state``."""
        from apex_tpu_torch.amp.scaler import Fp8DelayedScaler

        if not self.fp8_enabled:
            raise RuntimeError(
                f"init_fp8 needs the O4 opt level (got "
                f"{self.props.opt_level}): only O4 enables the fp8 tier")
        self.fp8_scaler = Fp8DelayedScaler(sites, history=history,
                                           margin=margin)
        self.fp8_state = self.fp8_scaler.init(device)
        return self.fp8_scaler

    # ---- functional protocol -----------------------------------------

    def scale(self, loss, scaler_state=None):
        return self.scaler.scale_loss(
            loss, scaler_state if scaler_state is not None
            else self.scaler_state)

    def scaled_update(self, tx, grads, opt_state, params, scaler_state,
                      overflow_reduce_axes=()):
        return _scaled_update(tx, self.scaler, grads, opt_state, params,
                              scaler_state,
                              overflow_reduce_axes=overflow_reduce_axes)

    # ---- stateful protocol -------------------------------------------

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None):
        """``with handle.scale_loss(loss) as scaled:``: yields the scaled
        loss; the unscale and the skip run in the attached optimizer's
        ``step``."""
        del optimizer
        yield self.scale(loss)

    def attach(self, optimizers):
        """Patch each ``FusedOptimizer``'s ``step`` (``handle.py:102``):
        unscale the grads, read the overflow flag on the host, and unless
        it overflowed update in place (the fp32 masters at O2 and O4,
        then the params copied from them), then move the loss scale.

        As in the reference, the masters are fp32 copies of the params
        the optimizer holds now (not of ``initialize``'s cast tree), and
        the state is re-initialised over them; the patched step uses the
        transform of the optimizer's first param group as it is now."""
        if not isinstance(optimizers, (list, tuple)):
            optimizers = [optimizers]
        for opt in optimizers:
            if any(ref() is opt for ref in self._optimizers):
                continue
            self._optimizers.append(weakref.ref(opt))
            use_master = bool(self.props.master_weights)
            if use_master:
                opt.master_params = _tree.map_leaves(
                    lambda p: p.detach().to(torch.float32, copy=True),
                    opt.params)
                opt.state = opt.tx.init(opt.master_params)
            opt.step = self._amp_step(opt, opt.tx, use_master)

    def _amp_step(self, opt, tx, use_master: bool):
        # the optimizer holds its step; the step holds it weakly (and the
        # handle only weak references to its optimizers), so there is no
        # reference cycle and a dropped optimizer frees its state at once
        opt_ref = weakref.ref(opt)
        handle = self

        def step(grads=None, closure=None):
            opt = opt_ref()
            loss = closure() if closure is not None else None
            if grads is None:
                raise ValueError("pass grads to step()")
            scaler = handle.scaler
            unscaled, overflow = scaler.unscale(grads, handle.scaler_state)
            del grads
            overflow = bool(overflow)  # the step's one host read
            if not overflow:
                target = opt.master_params if use_master else opt.params
                if use_master:
                    unscaled = _tree.map_leaves(lambda g: g.float(),
                                                unscaled)
                with torch.no_grad():
                    updates, opt.state = tx.update(unscaled, opt.state,
                                                   target)
                    del unscaled
                    _apply_updates(target, updates)
                    del updates
                    if use_master:
                        for p, m in zip(_tree.leaves(opt.params),
                                        _tree.leaves(opt.master_params)):
                            p.copy_(m)
            handle.scaler_state = scaler.update(handle.scaler_state,
                                                overflow)
            return loss if loss is not None else opt.params

        return step

    # ---- Apex's parity surface -----------------------------------------

    @property
    def is_active(self) -> bool:
        return bool(self.props.enabled)

    @property
    def verbose(self) -> bool:
        return _amp_state.verbosity > 1

    # Apex caches cast tensors; casts here happen where ops are called,
    # so the cache is always empty and exists for Apex-shaped loops.
    @property
    def cache(self) -> dict:
        return {}

    @property
    def has_cache(self) -> bool:
        return False

    def remove_cache(self) -> None:
        return None

    _clear_cache = remove_cache

    def wrap_optimizer(self, optimizer, num_loss=1):
        """Attach amp's unscale / skip / rescale to one optimizer and
        return it (``num_loss`` is kept for parity: the losses share the
        one scaler)."""
        del num_loss
        self.attach([optimizer])
        return optimizer

    @contextlib.contextmanager
    def disable_casts(self):
        """A region with mixed precision off: the policy's compute and
        param dtypes are fp32 inside it."""
        prev = self.policy
        self.policy = dataclasses.replace(
            prev, compute_dtype=torch.float32, param_dtype=torch.float32)
        try:
            yield
        finally:
            self.policy = prev

    # ---- checkpointing -----------------------------------------------

    def state_dict(self) -> dict:
        """The loss-scale automaton, plus the O4 ``"fp8"`` block once
        bound. A dict without the block loads into an fp8 handle with
        the rings left fresh; one with it loads into any handle."""
        d = self.scaler.state_dict(self.scaler_state)
        if self.fp8_scaler is not None and self.fp8_state is not None:
            d["fp8"] = self.fp8_scaler.state_dict(self.fp8_state)
        return d

    def load_state_dict(self, d: dict) -> None:
        self.scaler_state = self.scaler.load_state_dict(d)
        if self.fp8_scaler is not None and "fp8" in d:
            self.fp8_state = self.fp8_scaler.load_state_dict(
                d["fp8"], device=self.fp8_state.fwd.ring.device)


class NoOpHandle:
    """The handle of disabled amp: every operation is the identity."""

    @property
    def is_active(self) -> bool:
        return False

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None):
        yield loss

    def scale(self, loss, scaler_state=None):
        return loss

    def wrap_optimizer(self, optimizer, num_loss=1):
        del num_loss
        return optimizer

    @contextlib.contextmanager
    def disable_casts(self):
        yield

    @property
    def verbose(self) -> bool:
        return False

    @property
    def cache(self) -> dict:
        return {}

    @property
    def has_cache(self) -> bool:
        return False

    def remove_cache(self) -> None:
        return None

    _clear_cache = remove_cache

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        del d
