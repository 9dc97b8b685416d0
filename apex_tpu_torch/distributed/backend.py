"""Process groups and collectives over ``torch.distributed`` (port of
``apex_tpu/distributed/backend.py``).

The reference names a group by a mesh-axis name (``"dp"``, ``"data"``,
or a tuple of names) and runs its collectives inside ``shard_map``,
where the axis is bound. The port keeps those names: one registry in
this module binds each name to a ``torch.distributed`` ``ProcessGroup``,
and every collective that takes ``group`` resolves it there. A name that
is not bound raises ``NameError``, as an unbound axis does inside
``shard_map``. A ``ProcessGroup`` may also be passed as ``group`` as it
is.

- :func:`init_process_group` starts ``torch.distributed`` with an
  explicit backend, ``"nccl"`` for CUDA tensors or ``"gloo"`` for CPU
  tensors (or for several ranks sharing one GPU: gloo reduces CUDA
  tensors through the host), and binds the world group to
  ``axis_names``. Nothing switches backend or device by itself.
- :func:`new_group` binds a name to a new group of ranks.
- The collectives return new tensors, as the reference's do;
  :func:`all_gather` and :func:`reduce_scatter` keep the reference's
  ``axis`` and ``tiled`` meaning.

A tuple of names bound one by one (the axes of a grid of ranks) reduces
over each group in turn; a tuple bound as a whole is one group. Gathers,
scatters and broadcasts take one group.
"""

from __future__ import annotations

import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Group = Union[str, Sequence[str], "dist.ProcessGroup"]

BACKENDS = ("nccl", "gloo")

# name (a tuple of axis names) -> the ProcessGroup bound to it
_GROUPS: Dict[Tuple[str, ...], "dist.ProcessGroup"] = {}


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


# the ops torch.distributed reduces with as they are (SUM and AVG go
# through _AllReduceSum)
_TORCH_OPS = {ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _key(name) -> Tuple[str, ...]:
    return (name,) if isinstance(name, str) else tuple(name)


def _ranks_on_this_host(world_size: Optional[int]) -> int:
    for value in (os.environ.get("LOCAL_WORLD_SIZE"), world_size,
                  os.environ.get("WORLD_SIZE")):
        if value not in (None, "", -1):
            return int(value)
    return 1


def init_process_group(backend: str, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       axis_names: Sequence[str] = ("dp", "data"), **kw):
    """Start ``torch.distributed`` (ref ``backend.py:37``) and bind the
    world group to each of ``axis_names``.

    ``backend`` is ``"nccl"`` or ``"gloo"``, never chosen here.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``: what
    :mod:`apex_tpu_torch.parallel.multiproc` sets); ``world_size`` and
    ``rank`` default to the environment's. NCCL takes one rank per
    device: more ranks on this host (``LOCAL_WORLD_SIZE``, else the world
    size) than CUDA devices raises before any rank blocks in a
    rendezvous. ``kw`` goes to ``torch.distributed.init_process_group``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA device; use "
                               "backend='gloo' for CPU tensors")
        local, devices = _ranks_on_this_host(world_size), \
            torch.cuda.device_count()
        if local > devices:
            raise ValueError(
                f"backend='nccl' with {local} ranks on this host's "
                f"{devices} CUDA device(s): NCCL refuses two ranks on one "
                f"device (a communicator holds each GPU once). Give each "
                f"rank its own GPU, or use backend='gloo', which reduces "
                f"CUDA tensors through the host")
    args = {}
    if world_size is not None:
        args["world_size"] = int(world_size)
    if rank is not None:
        args["rank"] = int(rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **args, **kw)
    for name in axis_names:
        bind(name, dist.group.WORLD)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy_process_group() -> None:
    """Unbind every name and end ``torch.distributed``."""
    _GROUPS.clear()
    if is_initialized():
        dist.destroy_process_group()


def bind(axis_name, group: "dist.ProcessGroup") -> None:
    """Bind ``axis_name`` (a name or a tuple of names) to ``group``."""
    _GROUPS[_key(axis_name)] = group


def unbind(axis_name) -> None:
    """Forget the group bound to ``axis_name`` (a name or a tuple of
    names); an unbound name is left as it is."""
    _GROUPS.pop(_key(axis_name), None)


def is_bound(axis_name) -> bool:
    """True when ``axis_name`` (a name, or a tuple of names bound as a
    whole or one by one) resolves to groups here: the counterpart of an
    axis being bound inside ``shard_map``."""
    key = _key(axis_name)
    return bool(key) and (key in _GROUPS
                          or all((name,) in _GROUPS for name in key))


def new_group(axis_name, ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None):
    """A group of ``ranks`` (default all) bound to ``axis_name`` on its
    members (ref ``backend.py:83``, where groups are mesh axes). Every
    rank must call it, as ``torch.distributed.new_group`` requires.
    Returns ``axis_name``."""
    group = dist.new_group(ranks=list(ranks) if ranks is not None else None,
                           backend=backend)
    if ranks is None or dist.get_rank() in ranks:
        bind(axis_name, group)
    return axis_name


def get_group(group: Group) -> "dist.ProcessGroup":
    """The one ``ProcessGroup`` of ``group``: a bound name, a tuple bound
    as a whole, or a ``ProcessGroup``."""
    groups = _groups(group)
    if len(groups) != 1:
        raise ValueError(f"{group!r} names {len(groups)} groups; this "
                         f"collective takes one (bind the tuple as a whole "
                         f"with new_group)")
    return groups[0]


def _groups(group: Group) -> List["dist.ProcessGroup"]:
    if isinstance(group, dist.ProcessGroup):
        return [group]
    key = _key(group)
    if key in _GROUPS:
        return [_GROUPS[key]]
    missing = [name for name in key if (name,) not in _GROUPS]
    if missing or not key:
        raise NameError(
            f"unbound axis name: {missing[0] if missing else group!r} (bind "
            f"it with init_process_group(axis_names=...) or new_group)")
    return [_GROUPS[(name,)] for name in key]


def get_world_size(group: Optional[Group] = None) -> int:
    """Ranks in ``group`` (ref ``backend.py:60``); None: the world (1
    when ``torch.distributed`` is not started)."""
    if group is None:
        return dist.get_world_size() if is_initialized() else 1
    n = 1
    for g in _groups(group):
        n *= dist.get_world_size(g)
    return n


def get_rank(group: Optional[Group] = None) -> int:
    """This rank's index in ``group`` (ref ``backend.py:73``): for a
    tuple of groups, the composite ``r0 * n1 + r1 ...``; None: the global
    rank (0 when ``torch.distributed`` is not started)."""
    if group is None:
        return dist.get_rank() if is_initialized() else 0
    r = 0
    for g in _groups(group):
        r = r * dist.get_world_size(g) + dist.get_rank(g)
    return r


def divide(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as the reference divides (``x / jnp.asarray(d,
    x.dtype)``): a true division by a 0-dim tensor of ``x``'s dtype on
    ``x``'s device, never a product by a reciprocal."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the groups in turn; the gradient of a rank's input is the
    sum of every rank's output gradient (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, gy):
        return _AllReduceSum.apply(gy, ctx.groups), None


def all_reduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               group: Group = "dp") -> torch.Tensor:
    """The reduction of ``x`` over ``group`` (ref ``backend.py:97``), a
    new tensor. AVG is the sum divided by the group's size. SUM and AVG
    are differentiable, as the reference's psum is."""
    groups = _groups(group)
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        y = _AllReduceSum.apply(x, groups)
        return divide(y, get_world_size(group)) if op == ReduceOp.AVG else y
    y = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(y, op=_TORCH_OPS[op], group=g)
    return y


# the tensor forms of all-gather and reduce-scatter: ``*_single`` where
# torch has them, else their older names (deprecated once ``*_single``
# came)
def _all_gather_flat(out, x, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_flat(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather_into(out: torch.Tensor, x: torch.Tensor,
                    group: Group) -> None:
    """Every rank's ``x`` concatenated along dim 0 into ``out``."""
    _all_gather_flat(out, x, get_group(group))


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor,
                        group: Group) -> None:
    """The sum of every rank's ``x``, this rank's dim-0 slice of it into
    ``out``."""
    _reduce_scatter_flat(out, x, get_group(group))


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` stacked on a new dim 0; the gradient of a
    rank's input is its row of the sum of every rank's output
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        # gathered flat: gloo takes no stacked output shape
        out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x.contiguous().reshape(-1), group)
        return out.view((n,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, gout):
        g = gout.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group: Group = "dp", axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` (ref ``backend.py:116``): concatenated along
    ``axis`` when ``tiled``, else stacked on a new ``axis``.
    Differentiable."""
    out = _AllGather.apply(x, get_group(group))
    n = out.shape[0]
    axis = axis % (x.dim() + (0 if tiled else 1))
    out = out.movedim(0, axis)
    if tiled:
        shape = list(x.shape)
        shape[axis] *= n
        out = out.reshape(shape)
    return out.contiguous()


def reduce_scatter(x: torch.Tensor, group: Group = "dp", axis: int = 0,
                   op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's slice of it along
    ``axis`` (ref ``backend.py:121``, ``psum_scatter`` tiled)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter supports SUM/AVG")
    n = get_world_size(group)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    src = x.movedim(axis, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    reduce_scatter_into(out, src, group)
    if op == ReduceOp.AVG:
        out = divide(out, n)
    return out.movedim(0, axis).contiguous()


def _host_staged(x: torch.Tensor, g) -> bool:
    """True when ``x`` must pass through host memory to cross ``g``: a
    CUDA tensor over gloo, which takes CPU tensors for all-to-all."""
    return x.is_cuda and dist.get_backend(g) == "gloo"


def _all_to_all_raw(x: torch.Tensor, g, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all over ``g`` (not differentiable): one
    ``all_to_all_single`` on the chunks laid end to end. Over gloo a
    CUDA tensor is copied to pinned host memory, exchanged there and
    copied back; over NCCL the device tensors go as they are."""
    n = dist.get_world_size(g)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    chunks = x.chunk(n, dim=split_axis)
    staged = _host_staged(x, g)
    where = "cpu" if staged else x.device
    send = torch.empty((x.numel(),), dtype=x.dtype, device=where,
                       pin_memory=staged)
    step = x.numel() // n
    for i, c in enumerate(chunks):
        send[i * step:(i + 1) * step].view(c.shape).copy_(c)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    if staged:
        recv = recv.to(x.device)
    shape = chunks[0].shape
    return torch.cat([recv[i * step:(i + 1) * step].view(shape)
                      for i in range(n)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its gradient is the inverse all-to-all (the
    split and concat axes swapped), as JAX transposes ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, g, split_axis, concat_axis):
        ctx.g, ctx.axes = g, (split_axis, concat_axis)
        return _all_to_all_raw(x, g, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, gy):
        split_axis, concat_axis = ctx.axes
        return (_AllToAll.apply(gy, ctx.g, concat_axis, split_axis), None,
                None, None)


def all_to_all(x: torch.Tensor, group: Group = "cp", split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Chunk ``i`` of ``x`` along ``split_axis`` goes to rank ``i``; the
    chunks received are concatenated along ``concat_axis`` (ref
    ``backend.py:132``, tiled). Differentiable: the gradient goes back
    through the inverse all-to-all. CUDA tensors over a gloo group are
    staged through pinned host memory."""
    g = get_group(group)
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    return _AllToAll.apply(x, g, split_axis, concat_axis)


def broadcast(x: torch.Tensor, src: int = 0, group: Group = "dp"
              ) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (ref ``backend.py:139``);
    ``src`` is the rank within ``group``."""
    g = get_group(group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(g, src), group=g)
    return y


def barrier(group: Group = "dp") -> int:
    """Wait for every rank of ``group`` (ref ``backend.py:150``); returns
    the group's size, as the reference's psum of ones does."""
    for g in _groups(group):
        dist.barrier(group=g)
    return get_world_size(group)
