"""Fused label-smoothing cross entropy (port of
``apex_tpu/contrib/xentropy.py``; ref apex/contrib/xentropy/
softmax_xentropy.py ``SoftmaxCrossEntropyLoss``).

Per-token losses with label smoothing and padding-idx masking. The
forward saves the log-sum-exp and the backward reuses it, as the CUDA
kernel reuses ``max_log_sum_exp`` (the reference's ``custom_vjp``,
``xentropy.py:18-63``): a ``torch.autograd.Function`` here. The
reference runs it outside any Pallas kernel, and so does the port: plain
PyTorch, on whatever device the logits lie. Under an active O1 policy the
inputs are cast to fp32 (``amp.float_function``), as the reference's are.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.amp import float_function as _float_function


def _compute(logits: torch.Tensor, half_to_float: bool) -> torch.Tensor:
    return logits.float() if half_to_float else logits


def _lse(compute: torch.Tensor) -> torch.Tensor:
    m = compute.amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(compute - m).sum(dim=-1)) + m[..., 0]


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """Forward ``xentropy.py:28-46``; backward ``:49-59``: ``(softmax -
    ((1 - s) onehot + s / V)) * g``, 0 on padded tokens, in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx, half_to_float):
        compute = _compute(logits, half_to_float)
        lse = _lse(compute)
        target = torch.gather(compute, -1, labels[..., None])[..., 0]
        loss = lse - target
        if smoothing > 0.0:
            smooth = lse - compute.mean(dim=-1)
            loss = (1.0 - smoothing) * loss + smoothing * smooth
        pad = labels == padding_idx
        loss = torch.where(pad, torch.zeros((), dtype=loss.dtype,
                                            device=loss.device), loss)
        ctx.save_for_backward(logits, labels, lse, pad)
        ctx.smoothing, ctx.half_to_float = smoothing, half_to_float
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, pad = ctx.saved_tensors
        s = ctx.smoothing
        compute = _compute(logits, ctx.half_to_float)
        d = torch.exp(compute - lse[..., None])
        if s:
            d.sub_(s / compute.shape[-1])
        # the one-hot term, added where the label is, without a [N, V]
        # one-hot
        d.scatter_add_(-1, labels[..., None], torch.full(
            labels.shape + (1,), -(1.0 - s), dtype=d.dtype,
            device=d.device))
        scale = torch.where(pad, torch.zeros((), dtype=g.dtype,
                                             device=g.device), g)
        d.mul_(scale[..., None].to(d.dtype))
        return d.to(logits.dtype), None, None, None, None


def _softmax_cross_entropy_loss(logits, labels, smoothing=0.0,
                                padding_idx=0, half_to_float=False):
    """Per-token losses ``[N]`` of logits ``[N, V]`` (ref
    ``softmax_xentropy.py:5``): ``smoothing`` spreads that mass uniformly
    over the vocabulary; tokens equal to ``padding_idx`` give 0 loss and
    0 gradient. ``half_to_float`` computes in fp32 (the losses fp32),
    else in the logits' dtype."""
    return _SoftmaxCrossEntropy.apply(logits, labels, float(smoothing),
                                      padding_idx, bool(half_to_float))


# O1 boundary cast: cross-entropy is range-sensitive, so it runs in fp32
# under an active O1 policy (xentropy.py:65-69)
softmax_cross_entropy_loss = _float_function(_softmax_cross_entropy_loss)


class SoftmaxCrossEntropyLoss:
    """Class-shaped entry (the reference exposes the autograd.Function;
    ``apply`` == ``__call__``)."""

    apply = staticmethod(softmax_cross_entropy_loss)

    def __call__(self, logits, labels, smoothing=0.0, padding_idx=0,
                 half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)
