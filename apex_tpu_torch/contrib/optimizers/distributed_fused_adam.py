"""ZeRO-style distributed fused Adam (port of
``apex_tpu/contrib/optimizers/distributed_fused_adam.py``; ref
apex/contrib/optimizers/distributed_fused_adam.py).

Over the group bound to ``axis_name`` each rank passes its FULL local
grads; a step, for each param-dtype bucket (the flat layout of
``ops/flat.py``, padded to a multiple of the group's size n):

- the bucket's grads, packed in fp32, are reduce-scattered and divided
  by n: each rank holds the mean gradient of its ``1/n`` shard;
- the rank's fp32 master, m and v shards take one launch of the flat
  Adam kernel (``ops/fused_adam_kernel.py`` ``adam_flat``,
  ``csrc/fused_adam.cu``; its plain version on CPU tensors), m and v in
  place, the master += the kernel's delta;
- the new master shards are all-gathered and cast to the params' dtype.

So one Adam launch a dtype bucket a rank a step, and each rank holds
``1/n`` of the fp32 state. The state's layout is the reference's: one
flat shard a dtype bucket a rank (:class:`DistAdamState`, keyed by the
dtype's JAX name). ``update`` returns ``new_params - params`` in each
param's dtype, as the reference's transform does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.distributed.backend import divide
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops.fused_adam_kernel import adam_flat
from apex_tpu_torch.optimizers.fused_adam import _lr_at
from apex_tpu_torch.parallel.overlap import (
    OverlapPlan,
    _pack,
    _unpack_into,
    plan_overlap,
)

__all__ = ["DistAdamState", "DistributedFusedAdam",
           "dist_adam_partition_specs", "distributed_fused_adam"]


class ShardedTransformation(NamedTuple):
    """``init`` and ``update`` as an optax transform has them, and
    ``step(grads, state, params) -> (new leaves, state)``: each leaf's
    new value itself, the gathered master rounded once to the param's
    dtype (``params + update`` rounds twice)."""

    init: Callable
    update: Callable
    step: Callable


class DistAdamState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    master_shard: dict   # dtype name -> this rank's fp32 param shard
    mu_shard: dict
    nu_shard: dict


def _group(axis_name: str):
    """``(n, rank)`` of the group bound to ``axis_name``."""
    return backend.get_world_size(axis_name), backend.get_rank(axis_name)


def dtype_buckets(params, n: int) -> OverlapPlan:
    """One bucket a param dtype (dtype names sorted), each padded to a
    multiple of ``n``: the reference's ``flatten_tree`` buckets, as
    ``parallel/overlap.py`` plans and packs them."""
    total = sum(t.numel() * t.element_size() for t in _tree.leaves(params))
    return plan_overlap(params, bucket_cap_mb=total / 2 ** 20 + 1,
                        num_shards=n)


def shard_params(params, axis_name: str, dtype=torch.float32) -> dict:
    """This rank's shard of each dtype bucket of ``params`` in ``dtype``
    (the masters :func:`distributed_fused_adam` and ``_lamb`` start
    from)."""
    n, r = _group(axis_name)
    leaves = _tree.leaves(params)
    out = {}
    for bucket in dtype_buckets(params, n).buckets:
        size = bucket.padded // n
        out[bucket.dtype] = _pack(leaves, bucket, cast=dtype)[
            r * size:(r + 1) * size].clone()
    return out


def reduce_scatter_mean(leaves, bucket, axis_name: str,
                        dtype=torch.float32) -> torch.Tensor:
    """This rank's shard of the mean over the group of the bucket's
    ``leaves`` (the grads, packed in ``dtype``)."""
    n, _ = _group(axis_name)
    flat = _pack(leaves, bucket, cast=dtype)
    shard = torch.empty((bucket.padded // n,), dtype=dtype,
                        device=flat.device)
    backend.reduce_scatter_into(shard, flat, axis_name)
    return divide(shard, n)


def gather_params(shard: torch.Tensor, bucket, axis_name: str,
                  out: list) -> None:
    """Every rank's new master shard gathered and cast to the bucket's
    dtype, its leaves (views of one new buffer) into ``out``."""
    n, _ = _group(axis_name)
    full = torch.empty((bucket.padded,), dtype=shard.dtype,
                       device=shard.device)
    backend.all_gather_into(full, shard.contiguous(), axis_name)
    _unpack_into(out, full.to(getattr(torch, bucket.dtype)), bucket)


def distributed_fused_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, adam_w_mode: bool = True,
                           bias_correction: bool = True,
                           axis_name: str = "dp") -> ShardedTransformation:
    """The sharded transform (ref ``:41-111``); every rank of the group
    bound to ``axis_name`` calls ``init`` and each ``update`` with its
    full local grads."""
    b1, b2 = betas
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)

    def init(params):
        master = shard_params(params, axis_name)
        return DistAdamState(
            count=torch.zeros((), dtype=torch.int32), master_shard=master,
            mu_shard={k: torch.zeros_like(v) for k, v in master.items()},
            nu_shard={k: torch.zeros_like(v) for k, v in master.items()})

    @torch.no_grad()
    def step(grads, state, params):
        """-> (each leaf's new value, new state): the gathered masters in
        the params' dtype; the shards updated in place and carried into
        the new state."""
        count = state.count + 1
        lr_t = _lr_at(lr, state.count)  # optax: the pre-increment count
        step_f = count.to(torch.float32)
        g_leaves = _tree.leaves(grads)
        new: list = [None] * len(g_leaves)
        # grads pack in the PARAM buckets (fp32 grads of bf16 params go
        # with their params), cast to fp32
        for bucket in dtype_buckets(params, _group(axis_name)[0]).buckets:
            k = bucket.dtype
            g = reduce_scatter_mean(g_leaves, bucket, axis_name)
            master = state.master_shard[k]
            delta, _, _ = adam_flat(g, master, state.mu_shard[k],
                                    state.nu_shard[k], lr_t, step_f, **kw)
            master.add_(delta)
            del g, delta
            gather_params(master, bucket, axis_name, new)
        return new, state._replace(count=count)

    def update(grads, state, params=None):
        """-> (updates, new state): ``new - params`` in each param's
        dtype, as the reference returns them."""
        if params is None:
            raise ValueError("distributed_fused_adam requires params")
        new, state = step(grads, state, params)
        p_leaves = _tree.leaves(params)
        return (_tree.unflatten(_tree.paths(params), [
            n_ - p for n_, p in zip(new, p_leaves)]), state)

    return ShardedTransformation(init, update, step)


def dist_adam_partition_specs(params, mesh_axes=("dp",)) -> DistAdamState:
    """The partition spec of each :class:`DistAdamState` leaf (ref
    ``:114-135``), as the port writes specs (a tuple with one entry a
    dim): every shard split along dim 0 over ``mesh_axes`` (the ZeRO axis
    and any axis the params are split over), the count replicated. The
    global form of a shard concatenates the ranks' shards in rank
    order."""
    keys = sorted({_flat.dtype_name(leaf.dtype)
                   for leaf in _tree.leaves(params)})
    shard = {k: (tuple(mesh_axes),) for k in keys}
    return DistAdamState(count=(), master_shard=shard,
                         mu_shard=dict(shard), nu_shard=dict(shard))


class DistributedFusedAdam:
    """Class-shaped wrapper (ref ``:138``): ``init`` on every rank of the
    group, then ``step(grads)`` sets ``params`` in place to the gathered
    masters (each rounded once to its dtype) and returns them. The
    reference's NCCL scheduling knobs are accepted and ignored."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True, axis_name: str = "dp", **unused):
        del unused
        self.tx = distributed_fused_adam(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, bias_correction=bias_correction,
            axis_name=axis_name)
        self.params = params
        self.state = None

    def init(self, params=None):
        self.state = self.tx.init(params if params is not None
                                  else self.params)
        return self.state

    @torch.no_grad()
    def step(self, grads):
        return _step_in_place(self, grads)


def _step_in_place(opt, grads):
    """A class-shaped optimizer's step: ``opt.tx.step``, its new leaves
    copied into ``opt.params``."""
    if opt.state is None:
        opt.init()
    new, opt.state = opt.tx.step(grads, opt.state, opt.params)
    with torch.no_grad():
        for p, n_ in zip(_tree.leaves(opt.params), new):
            p.copy_(n_)
    return opt.params
