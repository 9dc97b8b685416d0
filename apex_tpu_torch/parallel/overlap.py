"""Bucketed gradient all-reduce overlapped with the backward (port of
``apex_tpu/parallel/overlap.py``).

- :func:`plan_overlap` — the static :class:`OverlapPlan`: per-dtype flat
  buckets capped at ``bucket_cap_mb``, from
  :func:`apex_tpu_torch.runtime.plan_buckets` (the reverse-order greedy),
  in grad-ready order: bucket 0 holds the LAST parameters, whose
  gradients the backward completes first.
- :func:`sync_gradients_overlapped` — after the backward: every bucket's
  all-reduce issued in plan order (``async_op``), then each waited on.
- :func:`overlapped_value_and_grad` — inside the backward. A gradient
  hook on each param leaf collects its bucket's gradients; the hook that
  completes a bucket packs it and issues its ``all_reduce(async_op=
  True)`` right there, while autograd goes on with the rest of the
  backward. The call waits on every handle before it returns the grads.

Both equal :func:`~apex_tpu_torch.parallel.sync_gradients` bit for bit
(the same predivide, sum, ``* predivide / n``; packing moves no value).

Where a parameter's gradient completes decides what can overlap. The
port keeps the reference's layouts, and its models stack the per-layer
weights ``[L, ...]``: a stacked leaf's gradient is complete only once
the backward of layer 0 has run, so its bucket is issued at the end of
the backward, and a tied embedding's with it. What the wrapped function
saw is kept in its ``last_trace`` (:class:`OverlapTrace`).

:func:`grad_sync_comms_bytes` prices one step's gradient sync (ring
all-reduce ``2(n-1)/n`` of the grad bytes, ZeRO-1 reduce-scatter plus
all-gather of the params ``(n-1)/n`` each).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.distributed.backend import divide
from apex_tpu_torch.observability.fleet import probe as fleet_probe
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.ops.flat import dtype_name


@dataclasses.dataclass(frozen=True)
class OverlapBucket:
    """One flat bucket: a contiguous run of same-dtype leaves."""

    dtype: str        # dtype name of the packed buffer
    indices: tuple    # leaf indices (JAX leaf order), ascending
    shapes: tuple     # per-leaf shapes
    sizes: tuple      # per-leaf element counts
    total: int        # sum(sizes)
    padded: int       # total rounded up to a multiple of num_shards

    @property
    def offsets(self):
        off, out = 0, []
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Static bucket schedule of one gradient tree: ``buckets`` in
    grad-ready (issue) order; ``num_shards`` is the ZeRO padding quantum
    (1 for plain all-reduce plans)."""

    buckets: tuple
    n_leaves: int
    bucket_cap_mb: float
    num_shards: int = 1

    def total_bytes(self) -> int:
        return sum(b.total * _torch_dtype(b.dtype).itemsize
                   for b in self.buckets)


def _pad_up(total: int, k: int) -> int:
    return total + ((-total) % max(1, k))


def plan_overlap(tree, bucket_cap_mb: float = 10.0,
                 num_shards: int = 1) -> OverlapPlan:
    """Grad-ready-ordered flat buckets of ``tree`` (ref ``:96``): per
    dtype (in sorted dtype-name order), bucket ids from the reverse-order
    greedy, each bucket a contiguous ascending run of leaf indices,
    padded to a multiple of ``num_shards``."""
    from apex_tpu_torch.runtime import plan_buckets

    leaves = _tree.leaves(tree)
    cap = int(bucket_cap_mb * 1024 * 1024)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
    buckets = []
    for dt in sorted(by_dtype):
        idxs = by_dtype[dt]
        ids = plan_buckets([leaves[i].numel() * leaves[i].element_size()
                            for i in idxs], cap)
        for b in range(max(ids) + 1 if ids else 0):
            members = [i for i, bid in zip(idxs, ids) if bid == b]
            sizes = tuple(leaves[i].numel() for i in members)
            total = int(sum(sizes))
            buckets.append(OverlapBucket(
                dtype=dt, indices=tuple(members),
                shapes=tuple(tuple(leaves[i].shape) for i in members),
                sizes=sizes, total=total,
                padded=_pad_up(total, num_shards)))
    return OverlapPlan(buckets=tuple(buckets), n_leaves=len(leaves),
                       bucket_cap_mb=bucket_cap_mb,
                       num_shards=max(1, int(num_shards)))


def _check_plan(plan: OverlapPlan, leaves) -> None:
    if plan.n_leaves != len(leaves):
        raise ValueError(
            f"OverlapPlan was built for {plan.n_leaves} leaves, tree "
            f"has {len(leaves)} — plan and gradient tree diverged")
    for b in plan.buckets:
        for i, shape in zip(b.indices, b.shapes):
            if tuple(leaves[i].shape) != shape:
                raise ValueError(
                    f"OverlapPlan leaf {i} expects shape {shape}, got "
                    f"{tuple(leaves[i].shape)} — plan and tree diverged")


def _pack(leaves, bucket: OverlapBucket, cast=None) -> torch.Tensor:
    """The bucket's leaves in one new flat buffer (in ``cast``, default
    the bucket's dtype), zero-padded to ``bucket.padded``."""
    dtype = cast or _torch_dtype(bucket.dtype)
    first = leaves[bucket.indices[0]]
    flat = torch.empty((bucket.padded,), dtype=dtype, device=first.device)
    for i, off, size in zip(bucket.indices, bucket.offsets, bucket.sizes):
        flat[off:off + size].copy_(leaves[i].reshape(-1))
    if bucket.padded != bucket.total:
        flat[bucket.total:].zero_()
    return flat


def _unpack_into(out: list, red: torch.Tensor, bucket: OverlapBucket):
    """Views of ``red``, one per leaf of the bucket, into ``out``."""
    for i, off, size, shape in zip(bucket.indices, bucket.offsets,
                                   bucket.sizes, bucket.shapes):
        out[i] = red[off:off + size].view(shape)


def _finish(red: torch.Tensor, n: int, gradient_average: bool,
            pre: float) -> None:
    """The reduction's last step, in place: ``* pre / n`` in the buffer's
    dtype when averaging (the reference's ``jnp.asarray(pre / n,
    dtype)``)."""
    if gradient_average:
        red.mul_(torch.tensor(pre / n, dtype=red.dtype, device=red.device))


def sync_gradients_overlapped(grads, axis_name: str = "data",
                              gradient_average: bool = True,
                              gradient_predivide_factor: float = 1.0,
                              bucket_cap_mb: float = 10.0,
                              plan: Optional[OverlapPlan] = None,
                              _site=None):
    """Bucket all-reduce of finished grads (ref ``:183``): every bucket
    packed and issued in plan order with ``async_op``, so the transfers
    queue back to back, then each waited on and unpacked. Each bucket's
    pack and issue runs under the span ``ddp/overlap/bucket{k}/{dtype}``
    (``_site(plan, k)`` names it for the bucketed sync)."""
    leaves = _tree.leaves(grads)
    if not leaves:
        return grads
    if plan is None:
        plan = plan_overlap(grads, bucket_cap_mb)
    _check_plan(plan, leaves)
    pre = gradient_predivide_factor
    group = backend.get_group(axis_name)
    n = backend.get_world_size(axis_name)
    # the fleet probe brackets the reference's sites, this function's own
    # buckets; the bucketed sync's (``_site``) are not probed there
    probed = _site is None
    pending = []
    for k, bucket in enumerate(plan.buckets):
        site = (f"ddp/overlap/bucket{k}/{bucket.dtype}" if probed
                else _site(plan, k))
        with span(site):
            flat = _pack(leaves, bucket)
            if pre != 1.0:
                flat = divide(flat, pre)
            if probed:
                flat = fleet_probe.collective_enter(flat, site, axis_name)
            work = torch.distributed.all_reduce(flat, group=group,
                                                async_op=True)
        pending.append((site, bucket, flat, work))
    out: list = [None] * len(leaves)
    for site, bucket, red, work in pending:
        work.wait()
        if probed:
            red = fleet_probe.collective_exit(red, site, axis_name)
        _finish(red, n, gradient_average, pre)
        _unpack_into(out, red, bucket)
    return _tree.unflatten(_tree.paths(grads), out)


@dataclasses.dataclass
class OverlapTrace:
    """When each bucket's all-reduce was issued, against the backward's
    end: ``issued`` holds ``(bucket index, host seconds, CUDA event or
    None)`` in issue order; ``end`` the same pair at the backward's end,
    ``synced`` once every bucket's reduction was waited on (the events
    are recorded on the stream the backward ran on)."""

    issued: List[tuple] = dataclasses.field(default_factory=list)
    end: Optional[tuple] = None
    synced: Optional[tuple] = None

    def mark(self, device: torch.device):
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(device))
        # the host's issue time, beside the event's device time: host
        # scheduling is what it records
        return time.perf_counter(), event  # apex-lint: disable=raw-clock


def _rebase(bucket: OverlapBucket) -> OverlapBucket:
    # the bucket's own grads are positions 0..k-1
    return dataclasses.replace(bucket,
                               indices=tuple(range(len(bucket.indices))))


def overlapped_value_and_grad(
        loss_fn: Callable, axis_name: str = "data",
        gradient_average: bool = True,
        gradient_predivide_factor: float = 1.0,
        bucket_cap_mb: float = 10.0,
        plan: Optional[OverlapPlan] = None,
        has_aux: bool = False) -> Callable:
    """``value_and_grad`` whose backward reduces each bucket as it
    completes (ref ``:227``).

    ``wrapped(params, *args, **kwargs)`` -> ``(loss, grads)`` (``((loss,
    aux), grads)`` with ``has_aux``), the grads reduced over
    ``axis_name`` and shaped like ``params``, ``loss`` detached.
    ``loss_fn``'s first argument is the params tree, a nested dict of
    tensors. ``wrapped.last_trace`` is the :class:`OverlapTrace` of the
    newest call.

    A gradient hook on each param leaf (``Tensor.register_hook``: autograd
    runs it as soon as the leaf's gradient is complete, every use of the
    leaf summed) hands the gradient to its bucket; the hook that
    completes a bucket packs it and issues its all-reduce. (The
    reference's transposed identity would here be a ``torch.autograd.
    Function`` made before the forward, which the autograd engine runs
    only after every node made later: at the backward's end.)"""
    pre = gradient_predivide_factor

    def wrapped(params, *args, **kwargs):
        leaves = _tree.leaves(params)
        plan_ = plan if plan is not None else plan_overlap(
            params, bucket_cap_mb)
        _check_plan(plan_, leaves)
        group = backend.get_group(axis_name)
        n = backend.get_world_size(axis_name)
        trace = OverlapTrace()
        pending = []

        def issue(k: int, bucket: OverlapBucket, grads: list):
            # on a card this runs on the autograd engine's device thread
            with span(f"ddp/overlap/bwd_bucket{k}/{bucket.dtype}"):
                flat = _pack(grads, _rebase(bucket))
                if pre != 1.0:
                    flat = divide(flat, pre)
                work = torch.distributed.all_reduce(flat, group=group,
                                                    async_op=True)
            pending.append((bucket, flat, work))
            trace.issued.append((k, *trace.mark(flat.device)))

        # each bucket's grads so far, by position in the bucket
        got = [{} for _ in plan_.buckets]

        def hook(k: int, bucket: OverlapBucket, pos: int):
            def on_grad(grad):
                got[k][pos] = grad
                if len(got[k]) == len(bucket.indices):
                    issue(k, bucket, [got[k][j]
                                      for j in range(len(bucket.indices))])
                    got[k] = None
            return on_grad

        live = [p.detach().requires_grad_() for p in leaves]
        for k, bucket in enumerate(plan_.buckets):
            for pos, i in enumerate(bucket.indices):
                live[i].register_hook(hook(k, bucket, pos))
        out = loss_fn(_tree.unflatten(_tree.paths(params), live),
                      *args, **kwargs)
        loss = out[0] if has_aux else out
        # the local grads it returns are dropped: the reduced ones are
        # the buckets'
        torch.autograd.grad(loss, live, allow_unused=True)
        trace.end = trace.mark(leaves[0].device)
        # a leaf the loss does not reach has a zero gradient (as its
        # cotangent is in the reference): its bucket goes now, on every
        # rank alike
        for k, bucket in enumerate(plan_.buckets):
            if got[k] is not None:
                issue(k, bucket, [
                    got[k].get(pos, torch.zeros_like(leaves[i]))
                    for pos, i in enumerate(bucket.indices)])
        grads: list = [None] * len(leaves)
        for bucket, red, work in pending:
            work.wait()
            _finish(red, n, gradient_average, pre)
            _unpack_into(grads, red, bucket)
        trace.synced = trace.mark(leaves[0].device)
        wrapped.last_trace = trace
        value = ((out[0].detach(), out[1]) if has_aux else out.detach())
        return value, _tree.unflatten(_tree.paths(params), grads)

    wrapped.last_trace = None
    return wrapped


# --------------------------------------------------------- comms model

GRAD_SYNC_MODES = ("allreduce", "zero1")


def grad_sync_bytes_from_sizes(grad_bytes: int, param_bytes: int,
                               axis_size: int,
                               mode: str = "allreduce") -> int:
    """Size-based core of :func:`grad_sync_comms_bytes` (ref ``:308``)."""
    n = max(1, int(axis_size))
    if n <= 1:
        return 0
    if mode == "allreduce":
        return int(2 * grad_bytes * (n - 1) / n)
    if mode == "zero1":
        return int((grad_bytes + param_bytes) * (n - 1) / n)
    raise ValueError(
        f"unknown grad-sync mode {mode!r}; valid: "
        f"{', '.join(GRAD_SYNC_MODES)}")


def grad_sync_comms_bytes(tree, axis_size: int, mode: str = "allreduce",
                          grad_dtype=torch.float32) -> int:
    """Bytes a rank moves for one step's gradient sync over ``tree`` (the
    params) under the ring model (ref ``:326``): ``allreduce`` moves
    ``2(n-1)/n`` of the grad bytes (grads in ``grad_dtype``, fp32 by
    default); ``zero1`` reduce-scatters the grads (``(n-1)/n`` of the
    grad bytes) and all-gathers the params in their own dtype
    (``(n-1)/n`` of the param bytes): 0.75x the all-reduce for bf16
    params and fp32 grads."""
    leaves = _tree.leaves(tree)
    gsize = torch.empty((), dtype=grad_dtype).element_size()
    grad_bytes = sum(leaf.numel() * gsize for leaf in leaves)
    param_bytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    return grad_sync_bytes_from_sizes(grad_bytes, param_bytes, axis_size,
                                      mode)
