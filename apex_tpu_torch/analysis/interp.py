"""Multi-lattice forward abstract interpretation over ATen graphs (port of
``apex_tpu/analysis/interp.py``): the one walk under the precision and
state engines, and the tracer that makes the graphs.

**The tracer.** :func:`trace` runs a function once under
``make_fx(tracing_mode="fake")``, autograd included (a backward the
function runs is traced into the same graph), and returns the ATen-level
``torch.fx.GraphModule``. Fake tensors hold no data, so a Llama-3-8B-width
step traces on the CPU in seconds. The port's hand-written kernels are
one node each (:mod:`apex_tpu_torch.ops.kernel_nodes`), with their launch
plans in ``node.meta["plan"]``, because the tracer's tensors dispatch as
the card's: on a CUDA build they are fake CUDA tensors; on a build
without CUDA, where autograd cannot run on a fake CUDA tensor, they are
fake CPU tensors that :func:`apex_tpu_torch.ops.kernel_config.
tracing_as_card` marks as the card's while the trace runs
(:func:`trace_device` says which). Either way
``kernel_config.dispatch`` takes the kernel path exactly as it does on
the card.

A graph comes in two forms. ``functional=True`` (the state and
precision engines) traces through ``torch.func.functionalize``: every
in-place update becomes an out-of-place op, and a write into an input
is a trailing ``copy_`` into its placeholder, which the walk reads as
that input's new value (:attr:`WalkResult.writes`): without it a
stateful ``FusedOptimizer.step`` or the serving decode step's in-place
page writes would read as state the step never carries.
``functional=False`` (the donation check) keeps the in-place ops in
their order.

**The walk.** Several :class:`Lattice` s ride one pass over the nodes
(:func:`interpret_lattices`): each gives initial values from a node's
``meta["val"]`` (:meth:`Lattice.for_val`), a transfer function per node
and an optional visitor. A multi-output node's value is a tuple, which
``operator.getitem`` nodes index. ``make_fx`` unrolls Python loops and
the port runs no ``torch.cond`` or ``while_loop``, so the reference's
scan/while/cond, ``warm_carry_join`` and shard_map hooks have nothing to
walk and are not ported (ROADMAP, "Deliberate differences").
"""

from __future__ import annotations

import contextlib
import operator
from typing import Any, Callable, List, NamedTuple, Sequence

import torch

__all__ = ["Lattice", "LatticeRun", "WalkResult", "flat_inputs",
           "interpret_lattices", "is_kernel_node", "kernel_nodes_of",
           "on_trace_device", "op_name", "output_nodes",
           "placeholder_nodes", "trace", "trace_device"]


def trace_device() -> torch.device:
    """The device of the tracer's fake tensors: CUDA on a build with a
    card, else the CPU standing in for it (module docstring)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def on_trace_device(make: Callable):
    """``make(device)`` run under a new fake-tensor mode on
    :func:`trace_device`: the inputs of a trace, at any size, with no
    memory behind them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return make(trace_device())


def flat_inputs(args) -> list:
    """The leaves of ``args`` in the order a trace's placeholders take
    them."""
    import torch.utils._pytree as pytree

    return pytree.tree_leaves(args)


def op_name(node) -> str:
    """A call node's op as ``namespace::name`` (``aten::mm``), the
    overload dropped; ``getitem`` for indexing; else the node's op."""
    if node.op != "call_function":
        return node.op
    if node.target is operator.getitem:
        return "getitem"
    name = getattr(node.target, "name", None)
    if callable(name):
        return name().split(".")[0]
    return getattr(node.target, "__name__", str(node.target))


def is_kernel_node(node) -> bool:
    from apex_tpu_torch.ops import kernel_nodes

    return op_name(node).startswith(f"{kernel_nodes.NAMESPACE}::")


def kernel_nodes_of(gm) -> List:
    """The hand-written kernels' nodes of a traced graph, in order."""
    return [n for n in gm.graph.nodes if is_kernel_node(n)]


def trace(fn: Callable, *args, functional: bool = True):
    """``fn(*args)`` as an ATen ``GraphModule`` (module docstring).

    ``args`` are fake tensors made by :func:`on_trace_device` (or real
    tensors, made fake here) in any pytree; a placeholder a leaf, in
    :func:`flat_inputs` order. Each kernel node carries
    ``meta["kernel"]`` (its C entry) and ``meta["plan"]`` (its launch
    plan by field)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from apex_tpu_torch.ops import kernel_config, kernel_nodes

    as_card = (kernel_config.tracing_as_card()
               if trace_device().type != "cuda"
               else contextlib.nullcontext())
    with as_card:
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
        if functional:
            # functionalize the ATen graph, not fn: the transform refuses
            # the autograd calls (requires_grad_, autograd.grad) of a step
            gm = make_fx(torch.func.functionalize(
                gm, remove="mutations_and_views"), tracing_mode="fake",
                _allow_non_fake_inputs=True)(*args)
    for node in gm.graph.nodes:
        plan = kernel_nodes.plan_of(node)
        if plan is not None:
            node.meta["kernel"] = op_name(node).split("::", 1)[1]
            node.meta["plan"] = plan
    return gm


class Lattice:
    """Value semantics for one analysis domain: initial values from a
    node's fake value, the per-node transfer function. Subclasses
    implement :meth:`for_val` and :meth:`transfer`."""

    name = "lattice"

    def for_val(self, val):
        """The value of a tensor (``val``: a fake tensor, or None) no
        input or transfer gave one."""
        raise NotImplementedError

    def for_const(self, node, const):
        """The value of a constant the graph holds (``get_attr``)."""
        return self.for_val(const)

    def transfer(self, node, ins, out_val, ctx):
        """``ins``: a value (or a list of values, for a list argument, or
        None for a non-tensor) a positional argument of ``node``;
        ``out_val``: the node's ``meta["val"]``. Returns the node's value,
        a tuple of them when ``out_val`` is a tuple or list."""
        raise NotImplementedError


class LatticeRun:
    """One lattice's part in a walk: the lattice, a value (or None: from
    the placeholder's fake value) a placeholder, and an optional
    ``visit(node, ins, out, ctx)``."""

    def __init__(self, lattice, in_vals=(), visit=None):
        self.lattice = lattice
        self.in_vals = list(in_vals or ())
        self.visit = visit


class WalkResult(NamedTuple):
    """One lattice's results: a value a flat output, and the new value of
    each input the graph writes in place ({placeholder index: value})."""

    outs: tuple
    writes: dict


def _is_seq(val) -> bool:
    return isinstance(val, (tuple, list))


def _args_values(node, env, k):
    def one(a):
        if isinstance(a, torch.fx.Node):
            row = env.get(a)
            return row[k] if row is not None else None
        if isinstance(a, (list, tuple)) and any(
                isinstance(x, torch.fx.Node) for x in a):
            return [one(x) for x in a]
        return None
    return tuple(one(a) for a in node.args)


def _default(lat, val):
    if _is_seq(val):
        return tuple(_default(lat, v) for v in val)
    return lat.for_val(val if isinstance(val, torch.Tensor) else None)


_COPY_ = "aten::copy_"


def interpret_lattices(gm, runs: Sequence[LatticeRun],
                       ctx: Any = None) -> List[WalkResult]:
    """Run every :class:`LatticeRun` over ``gm`` in ONE pass; returns a
    :class:`WalkResult` a run, in order. A ``copy_`` into a placeholder
    (a functional graph's input write) records that input's new value."""
    import torch.utils._pytree as pytree

    lats = [run.lattice for run in runs]
    env: dict = {}
    writes: List[dict] = [{} for _ in runs]
    placeholders: dict = {}
    results = None
    for node in gm.graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder":
            j = len(placeholders)
            placeholders[node] = j
            env[node] = [
                run.in_vals[j] if j < len(run.in_vals)
                and run.in_vals[j] is not None else _default(lat, val)
                for run, lat in zip(runs, lats)]
            continue
        if node.op == "get_attr":
            const = getattr(gm, node.target, None)
            env[node] = [lat.for_const(node, const) for lat in lats]
            continue
        if node.op == "output":
            leaves = pytree.tree_leaves(node.args[0])
            results = []
            for k, lat in enumerate(lats):
                results.append(tuple(
                    env[x][k] if isinstance(x, torch.fx.Node) and x in env
                    else None for x in leaves))
            continue
        if node.op != "call_function":
            env[node] = [_default(lat, val) for lat in lats]
            continue
        if node.target is operator.getitem:
            src, idx = node.args
            row = env.get(src)
            env[node] = [
                (row[k][idx] if row is not None and _is_seq(row[k])
                 and idx < len(row[k]) else _default(lat, val))
                for k, lat in enumerate(lats)]
            continue
        row = []
        for k, (run, lat) in enumerate(zip(runs, lats)):
            ins = _args_values(node, env, k)
            out = lat.transfer(node, ins, val, ctx)
            if run.visit is not None:
                run.visit(node, ins, out, ctx)
            row.append(out)
        env[node] = row
        if op_name(node) == _COPY_ and node.args[0] in placeholders:
            # the transfer of copy_ gives the value written, in the
            # input's dtype
            j = placeholders[node.args[0]]
            for k in range(len(runs)):
                writes[k][j] = row[k]
    if results is None:
        results = [() for _ in runs]
    return [WalkResult(outs=results[k], writes=writes[k])
            for k in range(len(runs))]


def placeholder_nodes(gm) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def output_nodes(gm) -> list:
    """The graph's flat outputs (nodes, or None for a non-tensor)."""
    import torch.utils._pytree as pytree

    for node in gm.graph.nodes:
        if node.op == "output":
            return [x if isinstance(x, torch.fx.Node) else None
                    for x in pytree.tree_leaves(node.args[0])]
    return []
