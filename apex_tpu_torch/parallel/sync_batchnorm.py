"""SyncBatchNorm (port of ``apex_tpu/parallel/sync_batchnorm.py``).

Batch statistics over the whole data-parallel group: each rank computes
its local (count, mean, M2 = sum of squared deviations), and the ranks
merge them with Chan's parallel update over two all-reduces, ``M =
sum(n_i m_i) / N`` then ``M2 = sum(M2_i + n_i (m_i - M)^2)``, never
forming a sum of squares (the reason for the reference CUDA Apex's
``welford.cu``: E[x^2] - E[x]^2 cancels for large-mean activations).
Running stats take the unbiased variance, as the reference does.

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


class SyncBatchNorm(torch.nn.Module):
    """Cross-rank BatchNorm (ref ``:27``; CUDA Apex's
    ``SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_group, channel_last)``), the process
    group a bound name, an ``(axis_name, group_size)`` pair or a
    ``ProcessGroup``. Its params and running stats go on ``device``, by
    default the current CUDA device."""

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

    def _stats(self, local_count, local_mean, local_m2):
        if not backend.is_initialized():
            return local_count, local_mean, local_m2
        if self.group_size is not None:
            n = backend.get_world_size(self.group)
            g = self.group_size
            if n % g:
                raise ValueError(f"group_size={g} must divide the group's "
                                 f"size {n}")
            start = (backend.get_rank(self.group) // g) * g
            packed = torch.cat([local_count.reshape(1), local_mean,
                                local_m2])
            rows = backend.all_gather(packed, self.group, axis=0,
                                      tiled=False)[start:start + g]
            c = local_mean.numel()
            return _merge(rows[:, 0], rows[:, 1:1 + c], rows[:, 1 + c:])
        total = backend.all_reduce(local_count, group=self.group)
        mean = backend.all_reduce(local_count * local_mean,
                                  group=self.group) / total
        m2 = backend.all_reduce(
            local_m2 + local_count * torch.square(local_mean - mean),
            group=self.group)
        return total, mean, m2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = x.dim() - 1 if (self.channel_last or x.dim() == 2) else 1
        dims = [i for i in range(x.dim()) if i != ch]
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        use_running = not self.training and self.track_running_stats
        if use_running:
            mean, var = self.running_mean, self.running_var
        else:
            x32 = x.float()
            local_count = torch.tensor(float(x.numel() // x.shape[ch]),
                                       device=x.device)
            local_mean = x32.mean(dims)
            # Welford M2: the centred sum of squares
            local_m2 = torch.square(x32 - local_mean.reshape(shape)).sum(
                dims)
            total, mean, m2 = self._stats(local_count, local_mean, local_m2)
            var = m2 / total
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var * total / torch.clamp(total - 1.0,
                                                         min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
        y = (x.float() - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps)
        if self.weight is not None:
            y = y * self.weight.float().reshape(shape)
            y = y + self.bias.float().reshape(shape)
        return y.to(x.dtype)


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
