"""Vocab-parallel cross entropy (port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

The logits' vocab dim is split over the tensor-parallel group; the loss
never needs the full-vocab logits on one rank (``cross_entropy.py:33-118``):

    1. global max  — a MAX all-reduce over tp (for a stable exp)
    2. sum of exp  — the local row sum, then a SUM all-reduce
    3. target logit — each rank masks the targets outside its vocab
       slice, gathers its own, and a SUM all-reduce combines them
       (exactly one rank holds each)

Label smoothing mixes in the mean over the whole vocabulary of
``-log p`` (its sum of logits all-reduced too). The backward is local:
``(softmax - onehot) * g`` on this rank's slice from the saved
``exp_logits``, ``sum_exp`` and target mask, the residuals the reference
saves. With no group bound for the axis it is the plain stable CE over
the whole vocabulary. Plain PyTorch: the JAX package has no Pallas
kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound


def _all_reduce(x, group, op=None):
    if group is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE of logits [..., vocab/tp] against global target ids
    [...]."""

    @staticmethod
    def forward(ctx, logits, target, label_smoothing: float, group):
        import torch.distributed as dist

        v_local = logits.shape[-1]
        n = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        vocab = v_local * n
        logits_max = _all_reduce(torch.amax(logits, dim=-1), group,
                                 None if group is None else dist.ReduceOp.MAX)
        logits = logits - logits_max[..., None]
        exp_logits = torch.exp(logits)
        sum_exp = _all_reduce(torch.sum(exp_logits, dim=-1), group)
        # ids outside this rank's [start, start + v_local) contribute no
        # target logit here; the rank holding them does
        local = target - rank * v_local
        in_range = (local >= 0) & (local < v_local)
        safe_target = torch.where(in_range, local, torch.zeros_like(local))
        predicted = torch.gather(logits, -1, safe_target[..., None])[..., 0]
        predicted = _all_reduce(
            torch.where(in_range, predicted, torch.zeros_like(predicted)),
            group)
        loss = torch.log(sum_exp) - predicted
        if label_smoothing > 0.0:
            mean_logit = _all_reduce(torch.sum(logits, dim=-1), group) / vocab
            smooth_loss = torch.log(sum_exp) - mean_logit
            loss = ((1.0 - label_smoothing) * loss
                    + label_smoothing * smooth_loss)
        ctx.save_for_backward(exp_logits, sum_exp, in_range, safe_target)
        ctx.label_smoothing = label_smoothing
        ctx.vocab = vocab
        return loss

    @staticmethod
    def backward(ctx, g):
        exp_logits, sum_exp, in_range, safe_target = ctx.saved_tensors
        ls = ctx.label_smoothing
        grad = exp_logits / sum_exp[..., None]
        hit = in_range.to(grad.dtype)[..., None]
        grad.scatter_add_(-1, safe_target[..., None],
                          -(1.0 - ls if ls > 0.0 else 1.0) * hit)
        if ls > 0.0:
            grad.sub_(ls / ctx.vocab)
        grad.mul_(g[..., None])
        return grad.to(exp_logits.dtype), None, None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 axis_name: Optional[str] = None, *,
                                 local: bool = False):
    """Per-token CE over vocab-split logits (ref ``cross_entropy.py:101``):
    ``axis_name`` (default ``"tp"``) names the group the vocab is split
    over; with none bound, or ``local=True`` (a single-device step in a
    process whose tp group is bound), the logits hold the whole
    vocabulary."""
    axis = axis_name if axis_name is not None else parallel_state.TENSOR_AXIS
    group = (_backend.get_group(axis) if _axis_bound(axis) and not local
             else None)
    return _VocabParallelCE.apply(vocab_parallel_logits, target,
                                  float(label_smoothing), group)
