"""ZeRO-1 FusedAdam over a data-parallel group (port of
``apex_tpu/parallel/zero.py``).

Each step, bucket by bucket of the :class:`~apex_tpu_torch.parallel.
overlap.OverlapPlan` (padded to a multiple of the group's size):

- the bucket's grads, cast to fp32, are **reduce-scattered**: each rank
  receives the sum of its ``1/n`` shard, ``(n-1)/n`` of the bytes of an
  all-reduce;
- the rank's shard of params and Adam moments is updated by the flat
  Adam kernel (:func:`apex_tpu_torch.ops.fused_adam_kernel.adam_flat`,
  ``csrc/fused_adam.cu``; its plain version on CPU tensors), m and v in
  place;
- the updated param shard is **all-gathered** in the params' dtype and
  copied into the params, which are updated in place as the port's train
  steps update them.

Each rank holds only its shards of the moments (``padded / n`` fp32
elements a bucket for each), on the params' device: 1/n of the
replicated optimizer's state.

Bit parity, as in the reference (``tests/run_parallel/test_zero1.py``):
with fp32 grads, a ZeRO-1 step equals
:func:`~apex_tpu_torch.parallel.sync_gradients` plus a replicated
``fused_adam(flat=True)`` step bit for bit, params and moments, wherever
the backend's reduce-scatter sums each element in the order its
all-reduce does (always at 2 ranks, where a + b = b + a; gloo's two
collectives order 4 ranks' terms differently). bf16 grads are reduced in
fp32 here, where the replicated path sums them in bf16: a documented
difference, not parity.

Checkpoints: outside a step, :meth:`Zero1FusedAdam.gather_state` gives
the reference's global layout, one ``(padded,)`` buffer a bucket (a
collective: every rank calls it), which
:mod:`apex_tpu_torch.checkpoint` saves under the reference's schema;
:meth:`Zero1FusedAdam.shard_state` slices a rank's shards back out of
it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.distributed.backend import divide
from apex_tpu_torch.observability.fleet import probe as fleet_probe
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.ops.fused_adam_kernel import adam_flat
from apex_tpu_torch.parallel.overlap import (
    OverlapPlan,
    _finish,
    _pack,
    _pad_up,
    _unpack_into,
    grad_sync_comms_bytes,
    plan_overlap,
)

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], float]]


class Zero1AdamState(NamedTuple):
    """Sharded FusedAdam state: ``count`` an int32 0-dim tensor on the
    CPU (as the port's FusedAdamState), ``mu``/``nu`` one fp32 buffer a
    plan bucket, this rank's ``(padded / n,)`` shard (or, from
    :meth:`Zero1FusedAdam.gather_state`, the global ``(padded,)``
    buffer)."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


def _lr_at(lr: ScalarOrSchedule, count):
    return lr(count) if callable(lr) else lr


class Zero1FusedAdam:
    """Bucketed ZeRO-1 FusedAdam over the group ``axis_name`` (ref
    ``:77``)::

        opt = Zero1FusedAdam(lr=1e-3, axis_name="dp")
        state = opt.init(params)               # this rank's shards
        params, state = opt.step(grads, state, params)   # every rank

    ``grads`` are a rank's local grads: the step reduces them (with
    ``gradient_average`` the mean over the group), so do not sync them
    before. Arguments mirror :func:`apex_tpu_torch.optimizers.fused_adam`.
    """

    def __init__(self, lr: ScalarOrSchedule = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, axis_name: str = "dp",
                 num_shards: Optional[int] = None,
                 bucket_cap_mb: float = 10.0,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0):
        if num_shards is None:
            num_shards = backend.get_world_size(axis_name)
        self.lr = lr
        self.bias_correction = bias_correction
        self.b1, self.b2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.axis_name = axis_name
        self.num_shards = int(num_shards)
        self.bucket_cap_mb = bucket_cap_mb
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor

    def plan_for(self, params) -> OverlapPlan:
        """The bucket schedule, padded to the shard quantum."""
        return plan_overlap(params, self.bucket_cap_mb,
                            num_shards=self.num_shards)

    def init(self, params) -> Zero1AdamState:
        """Zero moments: this rank's ``(padded / n,)`` fp32 shard of each
        bucket, on the params' device."""
        device = _device.of(params)
        mu = tuple(torch.zeros((b.padded // self.num_shards,),
                               dtype=torch.float32, device=device)
                   for b in self.plan_for(params).buckets)
        return Zero1AdamState(count=torch.zeros((), dtype=torch.int32),
                              mu=mu, nu=tuple(torch.zeros_like(m)
                                              for m in mu))

    def state_specs(self, params) -> Zero1AdamState:
        """The sharding of each state leaf as a partition spec (a tuple
        with one entry a dim): the moments split along dim 0 over
        ``axis_name``, the counter replicated (ref ``state_specs``, whose
        ``P(axis)`` and ``P()`` these encode as in a checkpoint)."""
        n = len(self.plan_for(params).buckets)
        return Zero1AdamState(count=(), mu=((self.axis_name,),) * n,
                              nu=((self.axis_name,),) * n)

    def _check_group(self) -> int:
        n = backend.get_world_size(self.axis_name)
        if n != self.num_shards:
            raise ValueError(
                f"Zero1FusedAdam was built for num_shards={self.num_shards}"
                f" but group {self.axis_name!r} has size {n} — state "
                f"shards would not line up")
        return n

    @torch.no_grad()
    def step(self, grads, state: Zero1AdamState, params):
        """One ZeRO-1 update on every rank of the group (ref ``:152``).
        Returns ``(params, state)``: the params updated in place on every
        rank, the state's moments updated in place in this rank's
        shard."""
        n = self._check_group()
        rank = backend.get_rank(self.axis_name)
        plan = self.plan_for(params)
        p_leaves = _tree.leaves(params)
        g_leaves = _tree.leaves(grads)
        if len(g_leaves) != len(p_leaves):
            raise ValueError(f"grads have {len(g_leaves)} leaves, params "
                             f"{len(p_leaves)} — trees diverged")
        if len(state.mu) != len(plan.buckets):
            raise ValueError(f"state has {len(state.mu)} bucket buffers, "
                             f"plan {len(plan.buckets)} — state/plan "
                             f"diverged")
        count = state.count + 1
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay,
                  adam_w_mode=self.adam_w_mode,
                  bias_correction=self.bias_correction)
        lr_t = _lr_at(self.lr, state.count)  # optax convention
        step_f = count.to(torch.float32)
        pre = self.gradient_predivide_factor
        for k, bucket in enumerate(plan.buckets):
            site = f"ddp/zero1/bucket{k}/{bucket.dtype}"
            with span(site):
                shard = bucket.padded // n
                # grads travel fp32 (the flat Adam slab's type), params in
                # their own dtype
                gflat = _pack(g_leaves, bucket, cast=torch.float32)
                if pre != 1.0:
                    gflat = divide(gflat, pre)
                # the fleet probe brackets the scatter + gather pair, the
                # ZeRO-1 sync region
                gflat = fleet_probe.collective_enter(gflat, site,
                                                     self.axis_name)
                g_shard = torch.empty((shard,), dtype=torch.float32,
                                      device=gflat.device)
                backend.reduce_scatter_into(g_shard, gflat, self.axis_name)
                del gflat
                _finish(g_shard, n, self.gradient_average, pre)
                pflat = _pack(p_leaves, bucket)
                p_shard = pflat[rank * shard:(rank + 1) * shard]
                delta, _, _ = adam_flat(g_shard, p_shard, state.mu[k],
                                        state.nu[k], lr_t, step_f, **kw)
                p_shard.add_(delta)
                del delta, g_shard
                backend.all_gather_into(pflat, p_shard.clone(), self.axis_name)
                pflat = fleet_probe.collective_exit(pflat, site,
                                                    self.axis_name)
                out: list = [None] * len(p_leaves)
                _unpack_into(out, pflat, bucket)
                for i in bucket.indices:
                    p_leaves[i].copy_(out[i])
                del pflat
        return params, state._replace(count=count)

    # ------------------------------------------------------- utilities

    def state_layout(self, params) -> dict:
        """The shard layout a checkpoint persists (ref ``:224``)."""
        return {"axis": self.axis_name, "num_shards": self.num_shards,
                "buckets": [{"dtype": b.dtype, "total": int(b.total),
                             "padded": int(b.padded)}
                            for b in self.plan_for(params).buckets]}

    def elastic_candidates(self, params, max_shards: Optional[int] = None
                           ) -> tuple:
        """Shard counts the saved global buffers can be re-sliced for
        without repacking (ref ``:240``): every ``n`` up to
        ``max_shards`` (default twice the current count) for which each
        bucket pads to the length it already has; always the current
        count."""
        plan = self.plan_for(params)
        limit = max_shards if max_shards is not None \
            else 2 * self.num_shards
        out = []
        for n in range(1, max(limit, self.num_shards) + 1):
            ok = all(b.padded % n == 0 and _pad_up(b.total, n) == b.padded
                     for b in plan.buckets)
            if ok or n == self.num_shards:
                out.append(n)
        return tuple(out)

    def comms_bytes(self, params) -> int:
        """Bytes a rank moves for one step's sync (ref ``:265``)."""
        return grad_sync_comms_bytes(params, self.num_shards, mode="zero1")

    def gather_state(self, state: Zero1AdamState) -> Zero1AdamState:
        """The reference's global state: each bucket's ``(padded,)``
        buffer, every rank's shard in rank order (a collective over the
        group; the count copied)."""
        self._check_group()

        def gather(shard):
            out = torch.empty((shard.numel() * self.num_shards,),
                              dtype=shard.dtype, device=shard.device)
            backend.all_gather_into(out, shard, self.axis_name)
            return out

        return Zero1AdamState(count=state.count.clone(),
                              mu=tuple(gather(m) for m in state.mu),
                              nu=tuple(gather(v) for v in state.nu))

    def shard_state(self, global_state: Zero1AdamState) -> Zero1AdamState:
        """This rank's shards of a global state (from
        :meth:`gather_state` or a restored checkpoint), as copies."""
        rank = backend.get_rank(self.axis_name)

        def shard(buf):
            if buf.numel() % self.num_shards:
                raise ValueError(f"a buffer of {buf.numel()} elements does "
                                 f"not split into {self.num_shards} shards")
            size = buf.numel() // self.num_shards
            return buf[rank * size:(rank + 1) * size].clone()

        return Zero1AdamState(count=global_state.count.clone(),
                              mu=tuple(shard(m) for m in global_state.mu),
                              nu=tuple(shard(v) for v in global_state.nu))

    def unpack_state(self, params, state: Zero1AdamState):
        """GLOBAL state buffers -> ``(mu_tree, nu_tree)`` shaped like
        ``params`` (ref ``:273``)."""
        plan = self.plan_for(params)
        trees = []
        for bufs in (state.mu, state.nu):
            if len(bufs) != len(plan.buckets):
                raise ValueError(
                    f"state has {len(bufs)} bucket buffers, plan "
                    f"{len(plan.buckets)} — state/plan diverged")
            leaves: list = [None] * plan.n_leaves
            for buf, bucket in zip(bufs, plan.buckets):
                _unpack_into(leaves, buf, bucket)
            trees.append(_tree.unflatten(_tree.paths(params), leaves))
        return tuple(trees)


def zero1_fused_adam(**kwargs) -> Zero1FusedAdam:
    """Factory mirroring :func:`apex_tpu_torch.optimizers.fused_adam`'s
    call shape (ref ``:293``)."""
    return Zero1FusedAdam(**kwargs)
