"""Fused optimizer update math (port of ``apex_tpu/optimizers/_math.py``).

The elementwise Adam, Adagrad, SGD, LAMB and NovoGrad bodies over
tensors, as the reference's CUDA multi-tensor kernels compute them; the
tree paths of the fused optimizers apply them leaf by leaf. State math
is fp32; params may be any float dtype.
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


def adagrad_step(g, p, h, *, lr, eps, weight_decay, adagrad_w_mode):
    """One Adagrad update (``_math.py:40``). Returns (delta, new_h);
    ``h`` is not modified. L2 mode adds the decay to the gradient before
    the accumulation, the decoupled mode (``adagrad_w_mode``) to the
    update after the division."""
    g32 = g.float()
    p32 = p.float()
    if not adagrad_w_mode and weight_decay:
        g32 = g32 + weight_decay * p32
    h = h + torch.square(g32)
    update = g32 / (torch.sqrt(h) + eps)
    if adagrad_w_mode and weight_decay:
        update = update + weight_decay * p32
    return -lr * update, h


def sgd_step(g, p, buf, *, lr, momentum, dampening, nesterov, weight_decay,
             wd_after_momentum, first_run: bool):
    """One (momentum) SGD update (``_math.py:53``). Returns (delta,
    new_buf) with delta = new_p - p in fp32; ``buf`` is not modified.
    ``first_run`` seeds the momentum buffer with the raw gradient, as the
    reference's first touch of a buffer does."""
    g32 = g.float()
    p32 = p.float()
    if weight_decay and not wd_after_momentum:
        g32 = g32 + weight_decay * p32
    if momentum:
        buf = (g32.clone() if first_run
               else momentum * buf + (1.0 - dampening) * g32)
        d = g32 + momentum * buf if nesterov else buf
    else:
        d = g32
    if weight_decay and wd_after_momentum:
        d = d + weight_decay * p32
    return -lr * d, buf


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


def novograd_step(g, p, m, v_norm, *, lr, b1, b2, eps, weight_decay,
                  grad_averaging, reg_inside_moment, step, bias_correction,
                  norm_type):
    """One NovoGrad update (``_math.py:117``). Returns (delta, new_m,
    new_v_norm). ``v_norm`` is the per-tensor EMA of the gradient's norm
    (the norm, not its square): L2 (``norm_type`` 2) blends root of
    squares, ``sqrt(b2 v^2 + (1 - b2) n^2)``, Linf (0) blends linearly;
    with ``bias_correction`` m is corrected by ``1 - b1^t`` and the norm
    by ``sqrt(1 - b2^t)``."""
    g32 = g.float()
    p32 = p.float()
    if norm_type == 0:
        gnorm = torch.amax(torch.abs(g32))
        v_new = b2 * v_norm + (1.0 - b2) * gnorm
    else:
        gnorm = torch.sqrt(torch.sum(torch.square(g32)))
        v_new = torch.sqrt(b2 * torch.square(v_norm)
                           + (1.0 - b2) * torch.square(gnorm))
    v_hat = (v_new / torch.sqrt(1.0 - b2 ** step) if bias_correction
             else v_new)
    scaled = g32 / (v_hat + eps)
    if weight_decay and reg_inside_moment:
        scaled = scaled + weight_decay * p32
    beta1_coeff = (1.0 - b1) if grad_averaging else 1.0
    m = b1 * m + beta1_coeff * scaled
    m_hat = m / (1.0 - b1 ** step) if bias_correction else m
    update = m_hat
    if weight_decay and not reg_inside_moment:
        update = update + weight_decay * p32
    return -lr * update, m, v_new
