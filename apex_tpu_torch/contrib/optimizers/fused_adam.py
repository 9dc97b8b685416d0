"""The contrib ``FusedAdam`` (port of
``apex_tpu/contrib/optimizers/fused_adam.py``): Apex's older duplicate
of ``apex.optimizers.FusedAdam``, L2 mode (``adam_w_mode=False``); its
legacy knobs (``eps_inside_sqrt``, ``max_grad_norm``, ``use_mt``,
``amp_scale_adjustment``) are accepted and ignored, as in the JAX
package."""

from __future__ import annotations

from apex_tpu_torch.optimizers.fused_adam import FusedAdam as _FusedAdam
from apex_tpu_torch.optimizers.fused_adam import fused_adam


class FusedAdam(_FusedAdam):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, amsgrad=False,
                 use_mt=False, amp_scale_adjustment=1.0):
        del eps_inside_sqrt, max_grad_norm, use_mt, amp_scale_adjustment
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, weight_decay=weight_decay,
                         amsgrad=amsgrad, adam_w_mode=False)


__all__ = ["FusedAdam", "fused_adam"]
