"""Data-parallel gradient sync (port of
``apex_tpu/parallel/distributed.py``).

Gradients and params are nested dicts of tensors (the params layout);
``axis_name`` names a process group bound in
:mod:`apex_tpu_torch.distributed.backend`, and every rank of it must
make the same calls. Each function returns new tensors.

The reduction keeps the reference's arithmetic: divide by
``gradient_predivide_factor``, sum over the group, then multiply by
``factor / n`` (in the gradient's dtype), so the flat and bucketed paths
equal the per-leaf one bit for bit.

Two deliberate differences from the reference (ROADMAP.md Queue 3):

- Under ``shard_map`` autodiff already sums the grads of replicated
  params over the axis (the transpose of their broadcast), except where
  a ``custom_vjp`` kernel hides the broadcast;
  :func:`sync_autodiff_gradients` there averages the summed leaves and
  means-reduces the local ones. In PyTorch each rank's autograd returns
  local grads only, so the port's :func:`sync_autodiff_gradients`
  means-reduces every leaf.
- :func:`average_reduced` keeps its documented contract: its input is
  already summed over the group, and it divides by the group's size.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.distributed.backend import divide
from apex_tpu_torch.observability.fleet import probe as fleet_probe
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.ops.flat import flatten_tree, unflatten_tree
from apex_tpu_torch.parallel.overlap import (
    _finish,
    sync_gradients_overlapped,
)


def _reduce(g: torch.Tensor, axis_name: str, gradient_average: bool,
            pre: float, site: str) -> torch.Tensor:
    """``g / pre``, summed over the group, ``* pre / n``: a new tensor.
    The sum is the fleet probe's ``site``."""
    if pre != 1.0:
        g = divide(g, pre)
    g = fleet_probe.collective_enter(g, site, axis_name)
    g = backend.all_reduce(g, backend.ReduceOp.SUM, axis_name)
    g = fleet_probe.collective_exit(g, site, axis_name)
    _finish(g, backend.get_world_size(axis_name), gradient_average, pre)
    return g


def sync_gradients(grads, axis_name: str = "data",
                   gradient_average: bool = True,
                   gradient_predivide_factor: float = 1.0):
    """All-reduce every leaf over ``axis_name`` (ref ``:55``); with
    ``gradient_average`` the mean over the group. Leaf ``i``'s sum is the
    fleet probe's site ``ddp/allreduce/leaf{i}``."""
    with span("ddp/allreduce"):
        leaves = _tree.leaves(grads)
        return _tree.unflatten(_tree.paths(grads), [
            _reduce(g, axis_name, gradient_average,
                    gradient_predivide_factor, f"ddp/allreduce/leaf{i}")
            for i, g in enumerate(leaves)])


def sync_gradients_flat(grads, axis_name: str = "data",
                        gradient_average: bool = True,
                        gradient_predivide_factor: float = 1.0):
    """Pack the leaves into one buffer per dtype, reduce each once,
    unpack (ref ``:90``)."""
    with span("ddp/allreduce_flat"):
        bufs, meta = flatten_tree(grads)
        reduced = {}
        for k, buf in bufs.items():
            with span(f"ddp/bucket/{k}"):
                reduced[k] = _reduce(buf, axis_name, gradient_average,
                                     gradient_predivide_factor,
                                     f"ddp/bucket/{k}")
        return unflatten_tree(reduced, meta)


def sync_gradients_bucketed(grads, axis_name: str = "data",
                            gradient_average: bool = True,
                            bucket_cap_mb: float = 10.0,
                            gradient_predivide_factor: float = 1.0):
    """Reduce in same-dtype buckets of at most ``bucket_cap_mb`` (ref
    ``:123``): the buckets of
    :func:`~apex_tpu_torch.parallel.overlap.plan_overlap` (the
    reverse-order greedy), reduced by
    :func:`~apex_tpu_torch.parallel.overlap.sync_gradients_overlapped`."""
    return sync_gradients_overlapped(
        grads, axis_name, gradient_average, gradient_predivide_factor,
        bucket_cap_mb=bucket_cap_mb, _site=_bucketed_site)


def _bucketed_site(plan, k: int) -> str:
    """The reference's span of bucket ``k``: ``ddp/bucket{b}/{dtype}``,
    ``b`` its index among the buckets of its dtype."""
    dt = plan.buckets[k].dtype
    b = sum(1 for x in plan.buckets[:k] if x.dtype == dt)
    return f"ddp/bucket{b}/{dt}"


def average_reduced(grads, axis_name: str = "data"):
    """Grads already summed over ``axis_name``, divided by its size (ref
    ``:174``)."""
    n = backend.get_world_size(axis_name)
    return _tree.map_leaves(lambda g: divide(g, n), grads)


def sync_autodiff_gradients(grads, axis_name: str = "data"):
    """The global-batch mean gradient from each rank's local one (ref
    ``:183``): every leaf summed over ``axis_name`` and divided by its
    size (the port's autograd never sums across ranks; see the module
    docstring)."""
    n = backend.get_world_size(axis_name)
    return _tree.map_leaves(
        lambda g: divide(backend.all_reduce(g, backend.ReduceOp.SUM,
                                            axis_name), n), grads)


class Reducer:
    """Averages a tree over the group on request (ref ``:201``):
    ``Reducer(params, axis_name).reduce()``."""

    def __init__(self, params_or_module=None, axis_name: str = "data"):
        self.axis_name = axis_name
        self.params = params_or_module

    def reduce(self, tree=None):
        tree = tree if tree is not None else self.params
        n = backend.get_world_size(self.axis_name)
        return _tree.map_leaves(
            lambda x: divide(backend.all_reduce(
                x, backend.ReduceOp.SUM, self.axis_name), n), tree)


class DistributedDataParallel:
    """Apex-shaped DDP over a model and its gradient trees (ref ``:217``).

    ``ddp.sync(grads)`` reduces a rank's local grads over ``axis_name``:
    per leaf, in one flat buffer per dtype (``flat_buckets``, the
    default), or in capped buckets issued together
    (``overlap_buckets``). ``delay_allreduce=True`` makes :meth:`sync` a
    no-op until :meth:`allreduce` (gradient accumulation);
    ``allreduce_always_fp32`` reduces in fp32 and casts back. To reduce
    inside the backward, as each bucket completes, use
    :func:`~apex_tpu_torch.parallel.overlap.overlapped_value_and_grad`.
    The options that tune the reference's NCCL streams are accepted and
    have no effect, as in the reference."""

    def __init__(self, module_or_apply: Any = None,
                 message_size: int = 10000000,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 gradient_average_split_factor=None, prof: bool = False,
                 axis_name: str = "data", flat_buckets: bool = True,
                 overlap_buckets: bool = False,
                 bucket_cap_mb: float = 10.0):
        if shared_param is not None:
            raise ValueError(
                "shared_param is deprecated (matches the reference's error; "
                "ref distributed.py:__init__)")
        del allreduce_trigger_params, retain_allreduce_buffers
        del num_allreduce_streams, allreduce_communicators, prof
        del gradient_average_split_factor, message_size
        self.module = module_or_apply
        self.axis_name = axis_name
        self.delay_allreduce = delay_allreduce
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.flat_buckets = flat_buckets
        self.overlap_buckets = overlap_buckets
        self.bucket_cap_mb = bucket_cap_mb

    def __call__(self, *args, **kwargs):
        if self.module is None:
            raise ValueError("DistributedDataParallel was built without a "
                             "module")
        fn = self.module
        if not isinstance(fn, torch.nn.Module):
            fn = getattr(fn, "apply", fn)
        return fn(*args, **kwargs)

    def _sync_fn(self, grads):
        if self.overlap_buckets:
            return sync_gradients_overlapped(
                grads, self.axis_name, self.gradient_average,
                self.gradient_predivide_factor,
                bucket_cap_mb=self.bucket_cap_mb)
        if self.flat_buckets:
            return sync_gradients_flat(
                grads, self.axis_name, self.gradient_average,
                self.gradient_predivide_factor)
        return sync_gradients(grads, self.axis_name, self.gradient_average,
                              self.gradient_predivide_factor)

    def _reduce(self, grads):
        if self.allreduce_always_fp32:
            synced = self._sync_fn(_tree.map_leaves(lambda g: g.float(),
                                                    grads))
            dtypes = _tree.map_leaves(lambda g: g.dtype, grads)
            return _tree.unflatten(
                _tree.paths(grads),
                [r.to(d) for r, d in zip(_tree.leaves(synced),
                                         _tree.leaves(dtypes))])
        return self._sync_fn(grads)

    def sync(self, grads):
        """Reduce grads over the group (a no-op under
        ``delay_allreduce``)."""
        if self.delay_allreduce:
            return grads
        return self._reduce(grads)

    def allreduce(self, grads):
        """The reduction, for the ``delay_allreduce`` accumulation
        pattern."""
        return self._reduce(grads)

    def average_reduced(self, grads):
        """The global-batch mean of each rank's local grads (see
        :func:`sync_autodiff_gradients`)."""
        if not self.gradient_average:
            return grads
        return sync_autodiff_gradients(grads, self.axis_name)

    def wrap_grad_fn(self, grad_fn: Callable) -> Callable:
        """A grad fn whose grads come back synced."""
        def wrapped(*args, **kwargs):
            out = grad_fn(*args, **kwargs)
            if isinstance(out, tuple):  # value_and_grad
                return (*out[:-1], self.sync(out[-1]))
            return self.sync(out)
        return wrapped
