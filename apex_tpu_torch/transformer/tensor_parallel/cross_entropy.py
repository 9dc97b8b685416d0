"""Vocab-parallel cross entropy, single-device path (port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py`` at
``axis=None``).

Stable log-sum-exp over the whole vocabulary; the backward is
``(softmax - onehot) * g`` from the saved ``exp_logits`` and ``sum_exp``,
the same residuals the reference saves. Label smoothing mixes in the
mean over the vocabulary of ``-log p``. Plain PyTorch: the JAX package
has no Pallas kernel here. The sharded path (a tensor-parallel process
group) comes with the multi-GPU slice.
"""

from __future__ import annotations

import torch


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE of logits [..., vocab] against target ids [...]."""

    @staticmethod
    def forward(ctx, logits, target, label_smoothing: float):
        vocab = logits.shape[-1]
        logits = logits - torch.amax(logits, dim=-1, keepdim=True)
        exp_logits = torch.exp(logits)
        sum_exp = torch.sum(exp_logits, dim=-1)
        # ids outside [0, vocab) contribute no target logit, as on a rank
        # that does not hold them
        in_range = (target >= 0) & (target < vocab)
        safe_target = torch.where(in_range, target, torch.zeros_like(target))
        predicted = torch.gather(logits, -1, safe_target[..., None])[..., 0]
        predicted = torch.where(in_range, predicted,
                                torch.zeros_like(predicted))
        loss = torch.log(sum_exp) - predicted
        if label_smoothing > 0.0:
            mean_logit = torch.sum(logits, dim=-1) / vocab
            smooth_loss = torch.log(sum_exp) - mean_logit
            loss = ((1.0 - label_smoothing) * loss
                    + label_smoothing * smooth_loss)
        ctx.save_for_backward(exp_logits, sum_exp, in_range, safe_target)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        exp_logits, sum_exp, in_range, safe_target = ctx.saved_tensors
        ls = ctx.label_smoothing
        vocab = exp_logits.shape[-1]
        grad = exp_logits / sum_exp[..., None]
        hit = in_range.to(grad.dtype)[..., None]
        grad.scatter_add_(-1, safe_target[..., None],
                          -(1.0 - ls if ls > 0.0 else 1.0) * hit)
        if ls > 0.0:
            grad.sub_(ls / vocab)
        grad.mul_(g[..., None])
        return grad.to(exp_logits.dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0):
    """Per-token CE over the full-vocab logits (ref
    ``cross_entropy.py:106`` with no tensor-parallel axis bound)."""
    return _VocabParallelCE.apply(vocab_parallel_logits, target,
                                  float(label_smoothing))
