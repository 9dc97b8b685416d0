"""Tensor- and sequence-parallel collective regions (port of
``apex_tpu/transformer/tensor_parallel/mappings.py``).

Each region is a ``torch.autograd.Function`` over the group bound to its
axis name (default ``"tp"``), with the backward that the reference's
autodiff gives its forward under ``shard_map``:

    copy            identity        -> all-reduce
    reduce          all-reduce      -> identity
    scatter         split           -> all-gather
    gather          all-gather      -> reduce-scatter
    reduce-scatter  reduce-scatter  -> all-gather

``gather``'s backward is a reduce-scatter (the transpose of a tiled
all-gather), not CUDA Apex's split, which assumes every rank holds the
same cotangent (``mappings.py:1-20``). The ``*_tensor_model_parallel_*``
regions act on the last dim, the sequence-parallel ones on ``seq_dim``.
With the axis not bound (no group for its name) every region is the
identity, so model code runs the same on one device.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.transformer import parallel_state


def _axis(axis_name: Optional[str]) -> str:
    """``None`` means the default tp axis name, as the reference's
    ``group=None`` means the default group."""
    return axis_name if axis_name is not None else parallel_state.TENSOR_AXIS


def _axis_bound(axis) -> bool:
    """True when ``axis`` names a bound group (the reference: a manual
    ``shard_map`` axis in the current trace)."""
    return axis is not None and _backend.is_bound(axis)


# ----------------------------------------------------- raw collectives


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _backend._all_gather_flat(out, x.contiguous().reshape(-1), group)
    out = out.view((n,) + tuple(x.shape)).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= n
    return out.reshape(shape)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's slice along ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _backend._reduce_scatter_flat(out, src, group)
    return out.movedim(0, dim).contiguous()


def _split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (a copy)."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    chunk = x.shape[dim] // n
    return x.narrow(dim, rank * chunk, chunk).contiguous()


# ----------------------------------------------------------- regions


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherSplitGrad(torch.autograd.Function):
    """All-gather forward; the backward keeps this rank's slice of the
    cotangent (for a cotangent every rank already holds whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _region(name, fn, x, axis_name, *dim):
    """``fn`` over the group bound to the axis, under the reference's
    span ``name`` (the forward's collective: the backward runs later,
    inside autograd)."""
    axis = _axis(axis_name)
    if not _axis_bound(axis):
        return x
    with span(name):
        return fn.apply(x, _backend.get_group(axis), *dim)


def copy_to_tensor_model_parallel_region(x, axis_name: Optional[str] = None):
    """Identity forward; gradients all-reduce over tp (ref mappings.py:108)."""
    return _region("tp/copy", _Copy, x, axis_name)


def reduce_from_tensor_model_parallel_region(x,
                                             axis_name: Optional[str] = None):
    """All-reduce forward; identity gradient (ref mappings.py:118)."""
    return _region("tp/allreduce", _Reduce, x, axis_name)


def scatter_to_tensor_model_parallel_region(x,
                                            axis_name: Optional[str] = None):
    """Keep this rank's last-dim chunk; gradients all-gather (ref
    mappings.py:127)."""
    return _region("tp/scatter", _Scatter, x, axis_name, x.dim() - 1)


def gather_from_tensor_model_parallel_region(x,
                                             axis_name: Optional[str] = None):
    """All-gather last-dim chunks into the full tensor; gradients
    reduce-scatter (ref mappings.py:140)."""
    return _region("tp/all_gather", _Gather, x, axis_name, x.dim() - 1)


def reduce_scatter_to_tensor_model_parallel_region(
        x, axis_name: Optional[str] = None):
    """Reduce-scatter over the last dim, the fused form of ``reduce_from``
    then ``scatter_to`` (ref mappings.py:150); gradients all-gather."""
    return _region("tp/reduce_scatter", _ReduceScatter, x, axis_name,
                   x.dim() - 1)


# --------------------------------------------------- sequence-parallel duals


def scatter_to_sequence_parallel_region(x, axis_name: Optional[str] = None,
                                        seq_dim: int = 0):
    """Split the sequence dim across tp ranks (Megatron's layout puts it
    first; the [b, s, h] models pass ``seq_dim=1``); gradients all-gather
    (ref mappings.py:172)."""
    return _region("sp/scatter", _Scatter, x, axis_name,
                   seq_dim % x.dim())


def gather_from_sequence_parallel_region(x, axis_name: Optional[str] = None,
                                         seq_dim: int = 0,
                                         tensor_parallel_output_grad=True):
    """All-gather the sequence dim; gradients reduce-scatter (ref
    mappings.py:185). ``tensor_parallel_output_grad=False`` (Megatron-LM's
    flag) is for an output whose cotangent every rank already holds
    whole, as the vocab-parallel chunked CE's all-reduced ``d_hidden``:
    the backward then keeps this rank's slice instead of summing the
    ranks' copies."""
    fn = _Gather if tensor_parallel_output_grad else _GatherSplitGrad
    return _region("sp/all_gather", fn, x, axis_name, seq_dim % x.dim())


def reduce_scatter_to_sequence_parallel_region(
        x, axis_name: Optional[str] = None, seq_dim: int = 0):
    """Reduce-scatter over the sequence dim (a row-parallel output under
    sequence parallelism); gradients all-gather (ref mappings.py:194)."""
    return _region("sp/reduce_scatter", _ReduceScatter, x, axis_name,
                   seq_dim % x.dim())
