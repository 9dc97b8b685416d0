"""Host-driven loss scalers of the pre-amp fp16 workflow (port of
``apex_tpu/fp16_utils/loss_scaler.py``).

The scaler is a Python object: ``update_scale(overflow)`` runs on the
host between steps. :class:`DynamicLossScaler` starts at 2^32, halves
(by ``scale_factor``) on an overflow, never below 1, and grows when
``(cur_iter - last_overflow_iter) % scale_window == 0``. Its overflow
check is one fused test over the whole tree: one wait for the device a
step, not one a leaf.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _tree


def _has_overflow(grads) -> bool:
    """Does any leaf hold an inf or a NaN: one flag made on the device,
    read once."""
    flags = [torch.isfinite(g).all() for g in _tree.leaves(grads)
             if isinstance(g, torch.Tensor)]
    if not flags:
        return False
    return not bool(torch.stack(flags).all())


class LossScaler:
    """Static scaler (``loss_scaler.py:23``): it never overflows, and
    ``scale_gradient`` divides by the scale."""

    def __init__(self, scale=1.0):
        self.cur_scale = float(scale)

    def has_overflow(self, params) -> bool:  # noqa: ARG002 - parity
        return False

    def update_scale(self, overflow) -> None:  # noqa: ARG002 - parity
        return None

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def scale_gradient(self, grads):
        leaves, treedef = _tree.flatten(grads)
        return treedef.unflatten([g / self.cur_scale for g in leaves])

    def backward(self, loss):
        """The scaled loss (the reference calls its ``backward()``)."""
        return loss * self.cur_scale


class DynamicLossScaler(LossScaler):
    """Host-side dynamic scaling (``loss_scaler.py:48``)."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, grads) -> bool:
        return _has_overflow(grads)

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) \
                % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
