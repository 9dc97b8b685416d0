"""Chunked lm-head + cross-entropy: the ``[N, vocab]`` logits are never
materialized (port of ``apex_tpu/transformer/functional/chunked_ce.py``).

The forward streams the vocabulary in ``num_chunks`` slices with an
online logsumexp (``chunked_ce.py:93``) and saves only the per-row lse;
the backward recomputes each chunk's logits from it (``:129``). So the
largest transient is one chunk's fp32 logits, ``N * vocab / num_chunks``
floats. All math is fp32 whatever the input dtypes, and each chunk's
products are ``torch.matmul``, as the reference leaves them to XLA
outside any Pallas kernel.

With ``tp_axis`` naming a bound group the weight is this rank's
``[h, V/tp]`` vocab slice (Megatron's layout): each rank streams its
slice, the per-rank (max, sum of exp, target logit) merge with a MAX
and two SUM all-reduces (``chunked_ce.py:115-121``), and the backward
all-reduces the partial ``d_hidden`` (``:156``).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.distributed import backend as _backend

__all__ = ["chunked_lm_cross_entropy"]


class _ChunkedCE(torch.autograd.Function):
    """Per-token CE of ``hidden @ weight (+ bias)`` against ``labels``
    (the ``custom_vjp`` ``_ce``)."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, num_chunks: int, group):
        import torch.distributed as dist

        vc = weight.shape[1] // num_chunks
        if group is not None:  # this rank's vocab slice starts here
            labels = labels - dist.get_rank(group) * weight.shape[1]
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
        if group is not None:
            # vocab-parallel merge of the per-rank streams
            m_g = m.clone()
            dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
            s = s * torch.exp(m - m_g)
            dist.all_reduce(s, group=group)
            dist.all_reduce(tgt, group=group)  # one rank holds each target
            m = m_g
        lse = torch.log(s) + m
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.num_chunks, ctx.group = num_chunks, group
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
        if ctx.group is not None:
            # each rank's dx covers its vocab slice's columns only
            import torch.distributed as dist

            dist.all_reduce(dx, group=ctx.group)
        dbias = torch.cat(dbs) if bias is not None else None
        return (dx.to(hidden.dtype), torch.cat(dws, dim=1), dbias, None,
                None, None)


def chunked_lm_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                             labels: torch.Tensor, num_chunks: int = 8,
                             tp_axis: Optional[str] = None,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Per-token CE of ``hidden @ weight (+ bias)`` vs ``labels`` without
    the ``[N, V]`` logits: ``hidden`` [N, h], ``weight`` [h, V] (pass
    ``embed.T`` for tied embeddings), ``labels`` [N] int, optional
    ``bias`` [V]. Returns per-token losses [N] in fp32
    (``chunked_ce.py:70``). ``tp_axis``: the bound group the vocab is
    split over (``weight`` [h, V/tp] and ``bias`` [V/tp] this rank's
    slices), None for the whole vocabulary here."""
    v = weight.shape[1]
    if v % num_chunks:
        raise ValueError(f"vocab {v} must divide into num_chunks="
                         f"{num_chunks}")
    group = _backend.get_group(tp_axis) if tp_axis is not None else None
    return _ChunkedCE.apply(hidden, weight, bias, labels.long(),
                            int(num_chunks), group)
