"""Chunked lm-head + cross-entropy: the ``[N, vocab]`` logits are never
materialized (port of ``apex_tpu/transformer/functional/chunked_ce.py``,
single-device: ``tp_axis=None``).

The forward streams the vocabulary in ``num_chunks`` slices with an
online logsumexp (``chunked_ce.py:93``) and saves only the per-row lse;
the backward recomputes each chunk's logits from it (``:129``). So the
largest transient is one chunk's fp32 logits, ``N * vocab / num_chunks``
floats. All math is fp32 whatever the input dtypes, and each chunk's
products are ``torch.matmul``, as the reference leaves them to XLA
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["chunked_lm_cross_entropy"]


class _ChunkedCE(torch.autograd.Function):
    """Per-token CE of ``hidden @ weight (+ bias)`` against ``labels``
    (the ``custom_vjp`` ``_ce``)."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, num_chunks: int):
        vc = weight.shape[1] // num_chunks
        x32 = hidden.float()
        n = x32.shape[0]
        m = torch.full((n,), -torch.inf, dtype=torch.float32,
                       device=x32.device)
        s = torch.zeros_like(m)
        tgt = torch.zeros_like(m)
        for lo in range(0, weight.shape[1], vc):
            logits = x32 @ weight[:, lo:lo + vc].float()
            if bias is not None:
                logits = logits + bias[lo:lo + vc].float()
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            s = (s * torch.exp(m - m_new)
                 + torch.sum(torch.exp(logits - m_new[:, None]), dim=-1))
            idx = labels - lo
            in_c = (idx >= 0) & (idx < vc)
            tl = torch.gather(logits, 1, idx.clamp(0, vc - 1)[:, None])[:, 0]
            tgt = torch.where(in_c, tl, tgt)
            m = m_new
            del logits
        lse = torch.log(s) + m
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.num_chunks = num_chunks
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        vc = weight.shape[1] // ctx.num_chunks
        x32 = hidden.float()
        g32 = g.float()
        dx = torch.zeros_like(x32)
        dws, dbs = [], []
        for lo in range(0, weight.shape[1], vc):
            w32 = weight[:, lo:lo + vc].float()
            logits = x32 @ w32
            if bias is not None:
                logits = logits + bias[lo:lo + vc].float()
            d = torch.exp(logits - lse[:, None])  # the softmax slice
            del logits
            idx = labels - lo
            in_c = (idx >= 0) & (idx < vc)
            d.scatter_add_(1, idx.clamp(0, vc - 1)[:, None],
                           -in_c.float()[:, None])
            d.mul_(g32[:, None])
            dx.add_(d @ w32.T)
            dws.append((x32.T @ d).to(weight.dtype))
            if bias is not None:
                dbs.append(torch.sum(d, dim=0).to(bias.dtype))
            del d, w32
        dbias = torch.cat(dbs) if bias is not None else None
        return (dx.to(hidden.dtype), torch.cat(dws, dim=1), dbias, None,
                None)


def chunked_lm_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                             labels: torch.Tensor, num_chunks: int = 8,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Per-token CE of ``hidden @ weight (+ bias)`` vs ``labels`` without
    the ``[N, V]`` logits: ``hidden`` [N, h], ``weight`` [h, V] (pass
    ``embed.T`` for tied embeddings), ``labels`` [N] int, optional
    ``bias`` [V]. Returns per-token losses [N] in fp32
    (``chunked_ce.py:70``)."""
    v = weight.shape[1]
    if v % num_chunks:
        raise ValueError(f"vocab {v} must divide into num_chunks="
                         f"{num_chunks}")
    return _ChunkedCE.apply(hidden, weight, bias, labels.long(),
                            int(num_chunks))
