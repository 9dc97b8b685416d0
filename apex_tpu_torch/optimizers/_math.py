"""Fused optimizer update math (port of ``apex_tpu/optimizers/_math.py``).

The elementwise Adam body over tensors, as the reference's CUDA
multi-tensor kernel computes it; the tree path of ``fused_adam`` applies
it leaf by leaf. State math is fp32; params may be any float dtype.
"""

from __future__ import annotations

import torch


def adam_step(g, p, m, v, *, lr, b1, b2, eps, weight_decay, adam_w_mode,
              step, bias_correction):
    """One Adam/AdamW update (``_math.py:18``). Returns (delta, new_m,
    new_v) with delta = new_p - p in fp32; m and v are not modified."""
    g32 = g.float()
    p32 = p.float()
    if not adam_w_mode and weight_decay:  # L2: decay into the gradient
        g32 = g32 + weight_decay * p32
    m = b1 * m + (1.0 - b1) * g32
    v = b2 * v + (1.0 - b2) * torch.square(g32)
    if bias_correction:
        m_hat = m / (1.0 - b1 ** step)
        v_hat = v / (1.0 - b2 ** step)
    else:
        m_hat, v_hat = m, v
    update = m_hat / (torch.sqrt(v_hat) + eps)
    if adam_w_mode and weight_decay:
        update = update + weight_decay * p32
    return -lr * update, m, v
