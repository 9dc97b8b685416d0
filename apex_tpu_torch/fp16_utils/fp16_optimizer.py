"""FP16_Optimizer (port of ``apex_tpu/fp16_utils/fp16_optimizer.py``).

Master-weight mixed precision around a :class:`FusedOptimizer`: the tree
the optimizer was given is the half-precision model tree (cast it first,
with ``tofp16`` or ``network_to_half``); the optimizer's params become
fp32 master copies of it, with its state made anew over them. A step
takes the model's (scaled) gradients, upcasts and unscales them, checks
them for inf and NaN on the host (one wait a step); an overflow skips
the step and only lowers the loss scale, else the masters take the
optimizer's step in place and a new model tree is the masters rounded to
the model's dtypes.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.fp16_utils.fp16util import (
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)


def _scaled(tree, factor):
    leaves, treedef = _tree.flatten(tree)
    return treedef.unflatten([g * factor for g in leaves])


class FP16_Optimizer:
    """Wrap a :class:`apex_tpu_torch.optimizers.FusedOptimizer`
    (``fp16_optimizer.py:27``). ``step(grads)`` takes the half-precision
    model's gradients of the scaled loss (:meth:`scale_loss`) and
    returns the refreshed model tree."""

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False):
        self.optimizer = init_optimizer
        self.model_params, master = prep_param_lists(init_optimizer.params)
        self.optimizer.params = master
        self.optimizer.state = self.optimizer.tx.init(master)
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False
        self.verbose = verbose

    def scale_loss(self, loss):
        return loss * self.loss_scaler.loss_scale

    def backward(self, loss):
        """The scaled loss, to differentiate (the reference's scaling
        shim)."""
        return self.scale_loss(loss)

    def step(self, grads=None, closure=None):
        """Unscale, check, and step the masters unless an overflow skips
        the step; returns the model tree (unchanged on a skip)."""
        del closure
        if grads is None:
            raise ValueError("pass grads (a tree like the params) to "
                             "step()")
        grads32 = _scaled(model_grads_to_master_grads(grads),
                          1.0 / self.loss_scaler.loss_scale)
        self.overflow = self.loss_scaler.has_overflow(grads32)
        self.loss_scaler.update_scale(self.overflow)
        if self.overflow:
            if self.verbose:
                print(f"OVERFLOW! Skipping step, reducing loss scale to "
                      f"{self.loss_scaler.loss_scale}")
            return self.model_params
        self.optimizer.step(grads32)
        self.model_params = master_params_to_model_params(
            self.model_params, self.optimizer.params)
        return self.model_params

    def clip_master_grads(self, grads, max_norm, norm_type=2):
        """Clip the unscaled fp32 gradients to ``max_norm``
        (``fp16_optimizer.py:89``): returns the clipped gradients
        rescaled for :meth:`step` (which unscales them again) and the
        norm before the clip. The gradients are not stored on the
        optimizer, so pass the tree that will go to ``step``::

            grads, norm = opt.clip_master_grads(grads, 1.0)
            opt.step(grads)
        """
        from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_

        scale = self.loss_scaler.loss_scale
        leaves, treedef = _tree.flatten(grads)
        grads32 = treedef.unflatten([g.float() * (1.0 / scale)
                                     for g in leaves])
        clipped, norm = clip_grad_norm_(grads32, max_norm,
                                        norm_type=norm_type)
        return _scaled(clipped, scale), norm

    def inspect_master_grad_data(self):
        """Nothing to inspect: gradients are passed to :meth:`step`, not
        stored (the reference returns None too)."""
        if self.verbose:
            print("FP16_Optimizer is functional: gradients are passed to "
                  "step(), not stored; inspect them at the call site")
        return None

    def zero_grad(self, set_to_none=True):  # noqa: ARG002 - parity
        return None

    def update_master_grads(self):  # done inside step()
        return None

    @property
    def loss_scale(self):
        return self.loss_scaler.loss_scale

    def state_dict(self) -> dict:
        return {"optimizer_state": self.optimizer.state_dict(),
                "cur_scale": self.loss_scaler.cur_scale,
                "overflow": self.overflow}

    def load_state_dict(self, d: dict) -> None:
        """Load this class's or the JAX package's state dict: an
        optimizer state whose leaves are numpy arrays (the reference's,
        pulled to the host) converts through ``opt_state_from_numpy``
        onto the masters' device."""
        opt_sd = dict(d["optimizer_state"])
        state = opt_sd["state"]
        if not all(isinstance(x, torch.Tensor)
                   for x in _tree.leaves(state)):
            from apex_tpu_torch.optimizers import opt_state_from_numpy

            device = _tree.leaves(self.optimizer.params)[0].device
            opt_sd["state"] = opt_state_from_numpy(state, device=device)
        self.optimizer.load_state_dict(opt_sd)
        self.loss_scaler.cur_scale = d["cur_scale"]
        self.overflow = d.get("overflow", False)
