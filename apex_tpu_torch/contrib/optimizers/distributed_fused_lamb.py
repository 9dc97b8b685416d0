"""ZeRO-style distributed fused LAMB (port of
``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``; ref
apex/contrib/optimizers/distributed_fused_lamb.py).

The reference shards LAMB's state over the data-parallel group and
computes the global gradient norm and the per-tensor param and update
norms over the shards in two stages (local partial sums, then an
all-reduce). A step over the group bound to ``axis_name``, each rank
passing its full local grads:

- each param-dtype bucket's grads are reduce-scattered and divided by n
  (packed and padded as ``distributed_fused_adam`` packs them);
- the global grad norm is the square root of the all-reduced sum of the
  shards' squares, and gives the clip coefficient;
- LAMB's moments and raw direction u run on the shard
  (``optimizers/_math.py``);
- ||p|| and ||u|| of each tensor: segment sums of the squares over the
  shard's slice of each tensor (``index_add_`` by a tensor id an
  element), all-reduced; the trust ratio a tensor, then an element;
- the new master shards are all-gathered in the params' dtype.

The state (fp32 master, m, v, or ``master_dtype``) lives only as
``1/n`` shards. Plain PyTorch, as the reference is ``jnp``: the trust
ratio needs whole-tensor norms between the moments and the update, which
the flat Adam kernel does not compute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    ShardedTransformation,
    _group,
    _step_in_place,
    dtype_buckets,
    gather_params,
    reduce_scatter_mean,
    shard_params,
)
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.optimizers import _math
from apex_tpu_torch.optimizers.fused_adam import _lr_at

__all__ = ["DistLAMBState", "DistributedFusedLAMB",
           "distributed_fused_lamb"]


class DistLAMBState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    master_shard: dict   # dtype name -> this rank's shard
    mu_shard: dict
    nu_shard: dict


def _segment_ids(bucket, rank: int, shard_size: int,
                 device) -> torch.Tensor:
    """The tensor index of each element of this rank's shard of the
    padded bucket (ref ``_segment_ids``, ``:49-54``, sliced to the
    shard); padding elements get ``T``, the number of tensors."""
    ends = torch.tensor(bucket.offsets[1:] + (bucket.total,),
                        dtype=torch.int64, device=device)
    pos = torch.arange(rank * shard_size, (rank + 1) * shard_size,
                       dtype=torch.int64, device=device)
    return torch.searchsorted(ends, pos, right=True)


def _segment_sq_norms(x, seg, n_seg: int, axis_name: str):
    """Each tensor's ||x||^2 over the whole bucket: this shard's
    segment sums of the squares, all-reduced over the group. The sums
    accumulate in float64: ``index_add_`` adds a segment's millions of
    terms into one slot one by one, which in fp32 drifts by percents."""
    sums = torch.zeros((n_seg + 1,), dtype=torch.float64, device=x.device)
    sums.index_add_(0, seg, torch.square(x.double()))
    return backend.all_reduce(sums, group=axis_name)[:n_seg].float()


def distributed_fused_lamb(
        lr=1e-3, bias_correction: bool = True, betas=(0.9, 0.999),
        eps: float = 1e-6, weight_decay: float = 0.01,
        adam_w_mode: bool = True, grad_averaging: bool = True,
        max_grad_norm: float = 1.0, use_nvlamb: bool = False,
        axis_name: str = "dp", master_dtype=torch.float32,
        fp32_reduce_scatter: bool = True) -> ShardedTransformation:
    """The sharded transform (ref ``:57-178``); every rank of the group
    bound to ``axis_name`` calls ``init`` and each ``update``.
    ``master_dtype`` is the stored shards' dtype (the step's math is
    fp32); ``fp32_reduce_scatter=False`` reduces the grads in their own
    dtype."""
    b1, b2 = betas

    def init(params):
        master = shard_params(params, axis_name, master_dtype)
        return DistLAMBState(
            count=torch.zeros((), dtype=torch.int32), master_shard=master,
            mu_shard={k: torch.zeros_like(v) for k, v in master.items()},
            nu_shard={k: torch.zeros_like(v) for k, v in master.items()})

    @torch.no_grad()
    def step(grads, state, params):
        """-> (each leaf's new value, new state), as
        ``distributed_fused_adam``'s."""
        n, rank = _group(axis_name)
        count = state.count + 1
        step = count.to(torch.float32)
        lr_t = _lr_at(lr, state.count)
        g_leaves = _tree.leaves(grads)
        plan = dtype_buckets(params, n)

        # stage 1: the grads' shards; the global norm from their squares
        gshards, gsq = {}, None
        for bucket in plan.buckets:
            rs_dtype = (torch.float32 if fp32_reduce_scatter
                        else g_leaves[bucket.indices[0]].dtype)
            g = reduce_scatter_mean(g_leaves, bucket, axis_name,
                                    rs_dtype).float()
            gshards[bucket.dtype] = g
            sq = torch.sum(torch.square(g))
            gsq = sq if gsq is None else gsq + sq
        gnorm = torch.sqrt(backend.all_reduce(gsq, group=axis_name))
        if max_grad_norm > 0.0:
            clip = torch.where(gnorm > max_grad_norm,
                               max_grad_norm / torch.clamp(gnorm, min=1e-30),
                               torch.ones_like(gnorm))
        else:
            clip = torch.ones_like(gnorm)

        # stage 2: LAMB on the shard, the per-tensor norms, the gather
        new: list = [None] * len(g_leaves)
        master_new, mu_new, nu_new = {}, {}, {}
        for bucket in plan.buckets:
            k = bucket.dtype
            g = gshards.pop(k)
            p = state.master_shard[k].float()
            m, v = _math.lamb_moments(
                g, p, state.mu_shard[k].float(), state.nu_shard[k].float(),
                b1=b1, b2=b2, grad_averaging=grad_averaging,
                clip_coeff=clip, weight_decay=weight_decay,
                adam_w_mode=adam_w_mode)
            del g
            u = _math.lamb_update_direction(
                p, m, v, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                adam_w_mode=adam_w_mode, step=step,
                bias_correction=bias_correction)
            T = len(bucket.sizes)
            seg = _segment_ids(bucket, rank, p.numel(), p.device)
            ratio_t = _math.lamb_trust_ratio(
                torch.sqrt(_segment_sq_norms(p, seg, T, axis_name)),
                torch.sqrt(_segment_sq_norms(u, seg, T, axis_name)),
                weight_decay=weight_decay, use_nvlamb=use_nvlamb)
            ratio = torch.cat([ratio_t, torch.ones(
                (1,), dtype=ratio_t.dtype, device=ratio_t.device)])[seg]
            master = p - lr_t * ratio * u
            del u, ratio, seg
            master_new[k] = master.to(master_dtype)
            mu_new[k], nu_new[k] = m.to(master_dtype), v.to(master_dtype)
            gather_params(master, bucket, axis_name, new)
        return new, DistLAMBState(count, master_new, mu_new, nu_new)

    def update(grads, state, params=None):
        """-> (updates, new state): ``new - params`` in each param's
        dtype, as the reference returns them."""
        if params is None:
            raise ValueError("distributed_fused_lamb requires params")
        new, state = step(grads, state, params)
        return (_tree.unflatten(_tree.paths(params), [
            n_ - q for n_, q in zip(new, _tree.leaves(params))]), state)

    return ShardedTransformation(init, update, step)


class DistributedFusedLAMB:
    """Class-shaped wrapper (ref ``:180``), as ``DistributedFusedAdam``:
    ``init`` on every rank of the group, then ``step(grads)`` sets
    ``params`` in place to the gathered masters. The reference's ``dwu_*`` chunking knobs are
    accepted and ignored."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 grad_averaging=True, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, max_grad_norm=0.0, adam_w_mode=True,
                 use_nvlamb=False, axis_name: str = "dp",
                 master_dtype=torch.float32, fp32_reduce_scatter=True,
                 **unused):
        del unused
        self.tx = distributed_fused_lamb(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            grad_averaging=grad_averaging, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, axis_name=axis_name,
            master_dtype=master_dtype,
            fp32_reduce_scatter=fp32_reduce_scatter)
        self.params = params
        self.state = None

    def init(self, params=None):
        self.state = self.tx.init(params if params is not None
                                  else self.params)
        return self.state

    @torch.no_grad()
    def step(self, grads):
        return _step_in_place(self, grads)
