"""Fused gradient clipping (port of ``apex_tpu/contrib/clip_grad.py``).

``clip_grad_norm_`` is :func:`apex_tpu_torch.fp16_utils.fp16util.
clip_grad_norm` (one global-norm clip over a tree of gradients) plus
torch's ``error_if_nonfinite``. Functional, as in the JAX package: the
clipped tree is returned, with the norm; nothing holds a ``.grad``.
"""

from __future__ import annotations

from typing import Union

import torch

from apex_tpu_torch.fp16_utils.fp16util import clip_grad_norm as _clip


def clip_grad_norm_(parameters, max_norm: float,
                    norm_type: Union[float, int] = 2.0,
                    error_if_nonfinite: bool = False):
    """``(clipped_grads, total_norm)``; with ``error_if_nonfinite`` a
    non-finite norm raises (reading it waits for the device)."""
    clipped, total_norm = _clip(parameters, max_norm, float(norm_type))
    if error_if_nonfinite and not bool(torch.isfinite(total_norm)):
        raise RuntimeError(
            f"the total norm of order {norm_type} is non-finite")
    return clipped, total_norm


clip_grad_norm = clip_grad_norm_
