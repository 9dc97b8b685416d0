"""Fused optimizer update math (port of ``apex_tpu/optimizers/_math.py``).

The elementwise Adam and LAMB bodies over tensors, as the reference's
CUDA multi-tensor kernels compute them; the tree paths of ``fused_adam``
and ``fused_lamb`` apply them leaf by leaf. State math is fp32; params
may be any float dtype.
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


def lamb_moments(g, p, m, v, *, b1, b2, grad_averaging, clip_coeff,
                 weight_decay, adam_w_mode):
    """LAMB stage 1: the moments of the clipped gradient (``_math.py:74``).
    In L2 mode the decay enters the gradient before the moments."""
    g32 = g.float() * clip_coeff
    if not adam_w_mode and weight_decay:
        g32 = g32 + weight_decay * p.float()
    beta1_coeff = (1.0 - b1) if grad_averaging else 1.0
    m = b1 * m + beta1_coeff * g32
    v = b2 * v + (1.0 - b2) * torch.square(g32)
    return m, v


def lamb_update_direction(p, m, v, *, b1, b2, eps, weight_decay,
                          adam_w_mode, step, bias_correction):
    """LAMB's raw update direction u, before the trust ratio
    (``_math.py:89``); AdamW mode adds the decoupled decay here."""
    if bias_correction:
        m_hat = m / (1.0 - b1 ** step)
        v_hat = v / (1.0 - b2 ** step)
    else:
        m_hat, v_hat = m, v
    u = m_hat / (torch.sqrt(v_hat) + eps)
    if adam_w_mode and weight_decay:
        u = u + weight_decay * p.float()
    return u


def lamb_trust_ratio(p_norm, u_norm, *, weight_decay, use_nvlamb):
    """Per-tensor trust ratio ||p|| / ||u|| (``_math.py:106``), 1 where
    either norm is 0; with NVLAMB off a param with no weight decay keeps
    ratio 1."""
    ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                        p_norm / torch.clamp(u_norm, min=1e-30),
                        torch.ones_like(p_norm))
    if not use_nvlamb and not weight_decay:
        ratio = torch.ones_like(ratio)
    return ratio
