"""Rotary position embedding (port of
``apex_tpu/transformer/functional/rope.py``).

Rotate-half (not interleaved) with fp32 trig and optional partial rotary
dim, the Megatron semantics the model families share. Plain PyTorch: the
JAX package has no Pallas kernel here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotary_freqs(seq_len: int, dim: int, base: float = 10000.0,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """[seq, dim] angle table theta_{t,i} (Megatron RotaryEmbedding)."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [seq, dim/2]
    return torch.cat([freqs, freqs], dim=-1).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def fused_apply_rotary_pos_emb(t: torch.Tensor,
                               freqs: torch.Tensor) -> torch.Tensor:
    """t * cos + rotate_half(t) * sin in fp32, back to t's dtype.

    ``freqs`` broadcasts against ``t`` ([..., dim]); a freqs dim smaller
    than t's rotates the leading slice and passes the rest through.
    """
    rot_dim = freqs.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    f = freqs.float()
    cos, sin = torch.cos(f), torch.sin(f)
    tr = t_rot.float()
    out = (tr * cos + _rotate_half(tr) * sin).to(t.dtype)
    if t_pass.shape[-1] == 0:
        return out
    return torch.cat([out, t_pass], dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Megatron-shaped entry: t [sq, b, np, hn], freqs [sq, 1, 1, hn]."""
    return fused_apply_rotary_pos_emb(t, freqs)


def apply_rotary_qk(
    q: torch.Tensor,
    k: torch.Tensor,
    freqs: Optional[torch.Tensor] = None,
    *,
    positions: Optional[torch.Tensor] = None,
    base: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding for [b, seq, heads, dim] q and k.

    ``positions`` ([b, seq] int) gives each row's own positions, from
    which the angles are computed directly (decode passes ``pos[:, None]``).
    """
    dim = q.shape[-1]
    if freqs is None:
        if positions is not None:
            inv = 1.0 / (base ** (torch.arange(
                0, dim, 2, dtype=torch.float32, device=q.device) / dim))
            half = positions.float()[..., None] * inv  # [b, s, d/2]
            freqs = torch.cat([half, half], dim=-1)
        else:
            freqs = rotary_freqs(q.shape[1], dim, base, device=q.device)
    if freqs.dim() == 2:  # [seq, dim] -> [1, seq, 1, dim]
        freqs = freqs[None, :, None, :]
    elif freqs.dim() == 3:  # [b, seq, dim] -> [b, seq, 1, dim]
        freqs = freqs[:, :, None, :]
    return (fused_apply_rotary_pos_emb(q, freqs),
            fused_apply_rotary_pos_emb(k, freqs))
