"""Context (sequence) parallelism (port of
``apex_tpu/transformer/context_parallel.py``).

Sequences are split over the ranks of the group bound to the ``"cp"``
axis (:mod:`apex_tpu_torch.transformer.parallel_state`): each rank holds
``s / cp`` tokens, layouts ``[batch, seq_local, heads, head_dim]``.

- :func:`ring_attention` is exact attention over the whole sequence as a
  ring of flash calls (the reference's ``_ring_flash``, ``:183-295``):
  each step runs the port's flash forward on the K/V block this rank
  holds and merges its (o, lse) into an fp32 accumulator by logsumexp;
  then K/V move one rank on. The backward runs the ring again, calling
  the flash dq and dk/dv kernels with the merged (global) o and lse, so
  each block's probabilities come out exactly; dK/dV accumulate in fp32
  and travel with their block, home after the full rotation. In a
  causal ring the block from this rank is the diagonal (causal), those
  from lower ranks are whole, and those from higher ranks are skipped:
  no launch, and their lse of -inf never reaches a kernel.
- :func:`ulysses_attention` swaps the sequence split for a head split
  with two all-to-alls around a plain attention over the whole sequence.
- :func:`split_sequence`, :func:`gather_sequence` and
  :func:`context_parallel_positions`.

The reference also has a jnp online-softmax ring (``:85-156``) for when
Pallas is off. The port's ring is the flash ring in every mode of
``kernel_config``: under ``force("off")``, and on CPU tensors, its block
calls take the flash kernels' plain versions, which give the same
function; a second ring would add code and, without the flash ring's
saved lse, memory, and no behaviour. K/V move with
``pipeline_parallel.p2p.shift_raw``, which stages CUDA tensors through
pinned host memory over a gloo group and sends them as they are over
NCCL.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.ops import flash_attention as _fa
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.pipeline_parallel import p2p as _p2p
from apex_tpu_torch.transformer.tensor_parallel import mappings

_NEG_INF = -1e30


def _axis(axis_name: Optional[str]) -> str:
    return axis_name if axis_name is not None else parallel_state.CONTEXT_AXIS


def _rotate(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's ``x`` to rank r + 1 of ``group``, cyclically."""
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        return x
    return _p2p.shift_raw(x, group, 1, cyclic=True)


def _lse_view(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``lse`` [B*H, S] as a [B, S, H, 1] view against ``like``
    [B, S, H, d]."""
    B, S, H, _ = like.shape
    return lse.view(B, H, S).transpose(1, 2)[..., None]


def _merge_lse(o_acc, lse_acc, o_i, lse_i):
    """Merge normalised block outputs by their logsumexps in fp32
    (``:173-180``): o [B, S, H, d], lse [B*H, S]."""
    lse_new = torch.logaddexp(lse_acc, lse_i)
    safe = torch.where(torch.isfinite(lse_new), lse_new,
                       torch.zeros_like(lse_new))
    w_a = _lse_view(torch.exp(lse_acc - safe), o_acc)
    w_i = _lse_view(torch.exp(lse_i - safe), o_acc)
    return o_acc * w_a + o_i.float() * w_i, lse_new


def _blocks(n: int, rank: int, causal: bool):
    """``(step, src, block_causal or None)`` for each ring step: the
    step's K/V block came from rank ``src``; None skips it."""
    for i in range(n):
        src = (rank - i) % n
        if not causal:
            yield i, src, False
        else:
            yield i, src, (True if src == rank
                           else False if src < rank else None)


class _RingFlash(torch.autograd.Function):
    """The flash ring over ``group``: q [B, S, H, d], k/v
    [B, S, H_kv, d] (GQA at H_kv heads, never repeated)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        import torch.distributed as dist

        n, rank = dist.get_world_size(group), dist.get_rank(group)
        B, S, H, _ = q.shape
        o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse_acc = torch.full((B * H, S), float("-inf"), dtype=torch.float32,
                             device=q.device)
        kv = torch.stack((k, v))
        for i, _, block_causal in _blocks(n, rank, causal):
            if block_causal is not None:
                o_i, lse_i = _fa._flash_fwd(q, kv[0], kv[1], block_causal,
                                            scale)
                o_acc, lse_acc = _merge_lse(o_acc, lse_acc, o_i, lse_i)
            if i < n - 1:
                kv = _rotate(kv, group)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        import torch.distributed as dist

        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack((k, v))
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=k.device)
        for i, _, block_causal in _blocks(n, rank, causal):
            if block_causal is not None:
                dq_i, dk_i, dv_i = _fa._flash_bwd(q, kv[0], kv[1], o, lse,
                                                  do, block_causal, scale)
                dq += dq_i.float()
                dkv[0] += dk_i.float()
                dkv[1] += dv_i.float()
            if i < n - 1:
                kv = _rotate(kv, group)
            # the accumulators travel with their block: after n moves
            # each is home with every rank's contribution
            dkv = _rotate(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, axis_name: Optional[str] = None,
                   causal: bool = True, scale: Optional[float] = None,
                   remat: bool = True):
    """Exact attention over a cp-split sequence (``:53``).

    q/k/v [b, s_local, h, d] (k/v may have fewer heads: GQA) are this
    rank's shard of the sequence, rank r holding positions
    ``[r * s_local, (r + 1) * s_local)``. Returns the output for the
    local queries in q's dtype. ``remat`` is the reference's switch for
    its jnp ring's recompute; the flash ring saves only q, k, v, o and
    lse whatever it is."""
    del remat
    b, s_local, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{h_kv}")
    sc = float(scale if scale is not None else 1.0 / (d ** 0.5))
    group = _backend.get_group(_axis(axis_name))
    return _RingFlash.apply(q, k, v, group, bool(causal), sc)


def _plain_attention(causal: bool, scale: Optional[float]):
    """Softmax attention in fp32 over the whole sequence (``:327-341``),
    the default ``attn_fn`` of :func:`ulysses_attention`."""
    def attn_fn(q, k, v):
        d = q.shape[-1]
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
        if causal:
            sq, sk = s.shape[-2], s.shape[-1]
            rows = torch.arange(sq, device=s.device)[:, None]
            cols = torch.arange(sk, device=s.device)[None, :]
            s = torch.where((cols > rows)[None, None],
                            torch.full_like(s, _NEG_INF), s)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return attn_fn


def ulysses_attention(q, k, v, attn_fn: Optional[Callable] = None,
                      axis_name: Optional[str] = None, causal: bool = True,
                      scale: Optional[float] = None):
    """All-to-all sequence parallelism (``:298``): trade the sequence
    split for a head split, attend over the whole sequence, swap back.
    Needs heads % cp == 0. ``attn_fn(q, k, v)`` on [b, s, h/cp, d]
    defaults to plain softmax attention with the 1/sqrt(d) scale."""
    axis = _axis(axis_name)

    def seq_to_heads(x):  # [b, s_local, h, d] -> [b, s, h / n, d]
        return _backend.all_to_all(x, axis, split_axis=2, concat_axis=1)

    def heads_to_seq(x):
        return _backend.all_to_all(x, axis, split_axis=1, concat_axis=2)

    attn = attn_fn if attn_fn is not None else _plain_attention(causal,
                                                                 scale)
    return heads_to_seq(attn(seq_to_heads(q), seq_to_heads(k),
                             seq_to_heads(v)))


def split_sequence(x, axis_name: Optional[str] = None, seq_dim: int = 1):
    """This rank's chunk of the sequence (``:349``; gradients
    all-gather)."""
    return mappings.scatter_to_sequence_parallel_region(
        x, _axis(axis_name), seq_dim=seq_dim)


def gather_sequence(x, axis_name: Optional[str] = None, seq_dim: int = 1):
    """The inverse of :func:`split_sequence` (``:359``)."""
    return mappings.gather_from_sequence_parallel_region(
        x, _axis(axis_name), seq_dim=seq_dim)


def context_parallel_positions(s_local: int, axis_name: Optional[str] = None,
                               device: _device.DeviceLike = None
                               ) -> torch.Tensor:
    """Global position ids of this rank's shard (``:366``), for RoPE:
    int64 on ``device`` (default: the GPU, raising when there is
    none)."""
    rank = _backend.get_rank(_axis(axis_name))
    return rank * s_local + torch.arange(s_local,
                                         device=_device.resolve(device))
