"""SyncBatchNorm (port of ``apex_tpu/parallel/sync_batchnorm.py``).

Batch statistics over the whole data-parallel group: each rank computes
its local (count, mean, M2 = sum of squared deviations), and the ranks
merge them with Chan's parallel update over all-reduces, ``M =
sum((n_i / N) m_i)`` then ``M2 = sum(M2_i + n_i (m_i - M)^2)``, never
forming a sum of squares (the reason for the reference CUDA Apex's
``welford.cu``: E[x^2] - E[x]^2 cancels for large-mean activations).
Running stats take the unbiased variance, as the reference does. The
backward is written out (:class:`_BatchNorm`): it all-reduces the two
per-channel sums the gradient of the statistics needs, and keeps only
the input for it.

:func:`sync_batch_norm` is the functional form, over any channel dim
and params passed in (the ResNet's BatchNorm switch,
``models/_common.py``); :class:`SyncBatchNorm` the module over it.

With ``group_size`` (or the ``(axis_name, group_size)`` pair that
:func:`~apex_tpu_torch.parallel.create_syncbn_process_group` returns),
groups of that many consecutive ranks share statistics: the per-rank
triples are all-gathered and this rank's group merged locally, as in the
reference.

The reference is a flax module whose channel axis defaults to the last
(NHWC); the port is a ``torch.nn.Module`` whose ``channel_last``
defaults to False (NCHW, PyTorch's and CUDA Apex's layout). Statistics
are fp32; the output has the input's dtype. When ``torch.distributed``
is not started the statistics are the local batch's (the reference's
behaviour outside ``shard_map``); inside a process group an unbound
name raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend


def _merge(counts, means, m2s):
    """Chan's merge of stacked per-rank ``(count [g], mean [g, C], M2
    [g, C])``."""
    total = counts.sum()
    mean = (counts[:, None] * means).sum(0) / total
    m2 = (m2s + counts[:, None] * torch.square(means - mean[None])).sum(0)
    return total, mean, m2


def _layout(x: torch.Tensor, ch: int):
    """The reduced dims of ``x`` and the shape a per-channel vector takes
    to broadcast against it."""
    dims = [i for i in range(x.dim()) if i != ch]
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return dims, shape


def _bound(group) -> bool:
    """Whether the statistics are merged across ranks: a group is named
    and ``torch.distributed`` is started (an unbound name then raises in
    the collective, as an unbound axis does in ``shard_map``)."""
    return group is not None and backend.is_initialized()


def local_moments(x: torch.Tensor, ch: int):
    """This rank's ``(count, mean, M2)`` over every dim of ``x`` but
    ``ch``, in fp32: M2 is the centred sum of squares (two passes, the
    reference's Welford ``M2``), never a sum of squares."""
    dims, shape = _layout(x, ch)
    x32 = x.float()
    count = torch.tensor(float(x.numel() // x.shape[ch]), device=x.device)
    mean = x32.mean(dims)
    m2 = torch.square(x32 - mean.reshape(shape)).sum(dims)
    return count, mean, m2


def merge_moments(count, mean, m2, group=None,
                  group_size: Optional[int] = None):
    """The statistics of the ranks of ``group`` merged by Chan's update
    (ref ``:95-124``): ``(total, mean, M2)``. ``group`` None, or
    ``torch.distributed`` not started, leaves this rank's. The mean is
    ``sum((n_i / N) m_i)``, each rank's weight taken first, so that at
    one rank (weight 1) the merge returns the local statistics bit for
    bit. With ``group_size`` the per-rank triples are all-gathered and
    this rank's group of consecutive ranks merged here."""
    if not _bound(group):
        return count, mean, m2
    if group_size is not None:
        n = backend.get_world_size(group)
        g = group_size
        if n % g:
            raise ValueError(f"group_size={g} must divide the group's "
                             f"size {n}")
        start = (backend.get_rank(group) // g) * g
        packed = torch.cat([count.reshape(1), mean, m2])
        rows = backend.all_gather(packed, group, axis=0,
                                  tiled=False)[start:start + g]
        c = mean.numel()
        return _merge(rows[:, 0], rows[:, 1:1 + c], rows[:, 1 + c:])
    total = backend.all_reduce(count, group=group)
    merged = backend.all_reduce((count / total) * mean, group=group)
    m2 = backend.all_reduce(m2 + count * torch.square(mean - merged),
                            group=group)
    return total, merged, m2


def _sum_over(sums: torch.Tensor, group, group_size: Optional[int]):
    """Per-channel sums summed over the ranks whose statistics this
    rank's normalisation used."""
    if not _bound(group):
        return sums
    if group_size is not None:
        start = (backend.get_rank(group) // group_size) * group_size
        rows = backend.all_gather(sums, group, axis=0, tiled=False)
        return rows[start:start + group_size].sum(0)
    return backend.all_reduce(sums, group=group)


class _BatchNorm(torch.autograd.Function):
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` in fp32, out in
    ``x``'s dtype, with the batch's statistics; the backward is the exact
    gradient through them. The statistics come from ``total`` elements a
    channel over the ranks of ``group``, so the gradient of ``x`` takes
    the per-channel sums of ``dy`` and ``dy * x_hat`` over those ranks
    (the transpose of the forward's all-reduces):

        dx = weight * rstd * (dy - sum(dy) / N - x_hat * sum(dy x_hat) / N)

    Only ``x`` (in its dtype) and the per-channel vectors are kept for
    the backward, as cuDNN's batch norm keeps them."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, total, eps, ch, group,
                group_size):
        _, shape = _layout(x, ch)
        rstd = torch.rsqrt(var + eps)
        mul = rstd if weight is None else rstd * weight.float()
        y = x.to(torch.float32, copy=True)
        y.sub_(mean.reshape(shape)).mul_(mul.reshape(shape))
        if bias is not None:
            y.add_(bias.float().reshape(shape))
        ctx.save_for_backward(x, weight, mean, rstd, total)
        ctx.ch, ctx.group, ctx.group_size = ch, group, group_size
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd, total = ctx.saved_tensors
        dims, shape = _layout(x, ctx.ch)
        xhat = x.to(torch.float32, copy=True)
        xhat.sub_(mean.reshape(shape)).mul_(rstd.reshape(shape))
        # a copy: the incoming gradient may feed another branch too
        dy32 = dy.to(torch.float32, copy=True)
        sums = torch.stack([dy32.sum(dims), (dy32 * xhat).sum(dims)])
        dw = sums[1].to(weight.dtype) if weight is not None else None
        db = (sums[0].to(ctx.bias_dtype, copy=True)
              if ctx.bias_dtype is not None else None)
        coef = _sum_over(sums, ctx.group, ctx.group_size) / total
        mul = rstd if weight is None else rstd * weight.float()
        xhat.mul_(coef[1].reshape(shape)).add_(coef[0].reshape(shape))
        dx = dy32.sub_(xhat).mul_(mul.reshape(shape))
        return (dx.to(x.dtype), dw, db, None, None, None, None, None, None,
                None)


def normalize(x, weight, bias, mean, var, total, eps: float, ch: int,
              group=None, group_size: Optional[int] = None):
    """``x`` normalised with the batch statistics ``mean`` and ``var``
    (fp32, per channel, over ``total`` elements a channel across
    ``group``'s ranks), scaled and shifted; differentiable through the
    statistics (:class:`_BatchNorm`). ``weight`` and ``bias`` may be
    None."""
    return _BatchNorm.apply(x, weight, bias, mean.detach(), var.detach(),
                            total.detach(), eps, ch, group, group_size)


def normalize_running(x, weight, bias, mean, var, eps: float, ch: int):
    """``x`` normalised with fixed (running) statistics, in fp32, out in
    ``x``'s dtype; ordinary autograd."""
    _, shape = _layout(x, ch)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight.float()
    y = (x.float() - mean.reshape(shape)) * mul.reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(x.dtype)


def sync_batch_norm(x, weight, bias, running_mean, running_var,
                    training: bool, momentum: float = 0.1,
                    eps: float = 1e-5, ch: int = 1, group="data",
                    group_size: Optional[int] = None):
    """The functional SyncBatchNorm: ``(y, new_mean, new_var)``.
    Training normalises with the statistics of the batch over
    ``group``'s ranks (Chan's merge, :func:`merge_moments`; ``group``
    None: this rank's) and moves the running stats by ``momentum`` (the
    fraction replaced) toward the mean and the unbiased variance, as the
    reference does (ref ``:126-129``); the new stats are new tensors.
    Otherwise the running stats normalise and come back as they are.
    ``ch`` is the channel dim of ``x`` (-1: channel-last)."""
    ch = ch % x.dim()
    if not training:
        return (normalize_running(x, weight, bias, running_mean,
                                  running_var, eps, ch),
                running_mean, running_var)
    with torch.no_grad():
        total, mean, m2 = merge_moments(*local_moments(x, ch), group,
                                        group_size)
        var = m2 / total
    y = normalize(x, weight, bias, mean, var, total, eps, ch, group,
                  group_size)
    if running_mean is None:
        return y, None, None
    with torch.no_grad():
        unbiased = var * total / torch.clamp(total - 1.0, min=1.0)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


class SyncBatchNorm(torch.nn.Module):
    """Cross-rank BatchNorm (ref ``:27``; CUDA Apex's
    ``SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_group, channel_last)``), the process
    group a bound name, an ``(axis_name, group_size)`` pair or a
    ``ProcessGroup``. Its params and running stats go on ``device``, by
    default the current CUDA device. The module form of
    :func:`sync_batch_norm`."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_group: Union[None, str, tuple,
                                      "torch.distributed.ProcessGroup"]
                 = None,
                 channel_last: bool = False, axis_name: str = "data",
                 group_size: Optional[int] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(process_group, tuple):
            process_group, tuple_size = process_group
            group_size = tuple_size if group_size is None else group_size
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.group = process_group if process_group is not None \
            else axis_name
        self.group_size = group_size
        self.channel_last = channel_last
        if affine or track_running_stats:
            device = _device.resolve(device)
        if affine:
            self.weight = torch.nn.Parameter(
                torch.ones(num_features, device=device, dtype=dtype))
            self.bias = torch.nn.Parameter(
                torch.zeros(num_features, device=device, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, device=device, dtype=torch.float32))
            self.register_buffer("running_var", torch.ones(
                num_features, device=device, dtype=torch.float32))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = x.dim() - 1 if (self.channel_last or x.dim() == 2) else 1
        training = self.training or not self.track_running_stats
        y, mean, var = sync_batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training, self.momentum, self.eps, ch, self.group,
            self.group_size)
        if training and self.track_running_stats:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


def convert_syncbn_model(module: torch.nn.Module, process_group=None,
                         channel_last: bool = False) -> torch.nn.Module:
    """Every ``torch.nn.BatchNorm1d/2d/3d`` in ``module``'s tree replaced
    by a :class:`SyncBatchNorm` with its settings, params and running
    stats (ref ``:160``; CUDA Apex's ``convert_syncbn_model``). Returns
    the converted module (``module`` itself, changed in place, unless it
    is a BatchNorm); a tree with no BatchNorm passes through
    unchanged."""
    if isinstance(module, torch.nn.modules.batchnorm._BatchNorm) and \
            not isinstance(module, SyncBatchNorm):
        w = module.weight
        held = w if w is not None else module.running_mean
        sync = SyncBatchNorm(
            module.num_features, eps=module.eps,
            momentum=module.momentum if module.momentum is not None
            else 0.1,
            affine=module.affine,
            track_running_stats=module.track_running_stats,
            process_group=process_group, channel_last=channel_last,
            device=held.device if held is not None else None,
            dtype=w.dtype if w is not None else torch.float32)
        with torch.no_grad():
            if module.affine:
                sync.weight.copy_(module.weight)
                sync.bias.copy_(module.bias)
            if module.track_running_stats:
                sync.running_mean.copy_(module.running_mean)
                sync.running_var.copy_(module.running_var)
        sync.train(module.training)
        return sync
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group, channel_last)
        if new is not child:
            setattr(module, name, new)
    return module
