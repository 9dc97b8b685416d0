"""Tensor statistics for whole trees (port of
``apex_tpu/observability/numerics/stats.py``).

:func:`tensor_stats` computes amax / l2-norm / underflow-fraction /
zero-fraction / finite-flag for EVERY floating leaf of a tree on the
leaf's device, and stacks the per-leaf scalars into five small vectors,
so the host does ONE fetch for the whole tree. A Python loop of
``bool(torch.isnan(leaf).any())`` host pulls per tensor would serialize
the step on device round trips.

Each leaf is reduced in fp32 with the underflow threshold of its own
dtype (``torch.finfo(dtype).tiny``), so a bf16 tensor reports bf16
underflow, as the reference's jitted pass does. The reference's pass
is one fused XLA program; here each leaf is reduced in chunks of at most
:data:`CHUNK_ELEMENTS` elements, so the fp32 copy of a large bf16 leaf
(Llama-3-8B's 128,256 x 4096 embedding would be a 2.1 GB transient) is
never made whole. Leaf paths use the reference's key format
(``layers/wq``, ``0/1``), so the two packages name tensors alike.

:class:`StatsCollector` is the decimated runner: stats are computed and
pulled only every ``every`` steps, one fetch a pull, and the pass's cost
lands in the ``numerics/stats_pass`` timer and the summary's
``stats_pass_ms``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

__all__ = [
    "TENSOR_STAT_FIELDS", "CHUNK_ELEMENTS", "TreeStats", "tree_paths",
    "leaf_paths", "tensor_stats", "host_tensor_stats", "nonfinite_paths",
    "summarize_stats", "StatsCollector",
]

#: per-tensor statistics every stats pass computes, in stack order.
TENSOR_STAT_FIELDS = ("amax", "l2", "underflow_frac", "zero_frac",
                      "finite")

#: the most elements of a leaf reduced at once (64 MiB of fp32)
CHUNK_ELEMENTS = 1 << 24


class TreeStats(NamedTuple):
    """Stacked per-leaf statistics (one entry per floating leaf, in
    ``leaf_paths`` order), on the device of the tree's first such leaf
    until one host fetch pulls the whole tuple."""

    amax: object            # f32[n]  max |x|
    l2: object              # f32[n]  sqrt(sum x^2)
    underflow_frac: object  # f32[n]  fraction with 0 < |x| < tiny
    zero_frac: object       # f32[n]  fraction exactly zero
    finite: object          # bool[n] all-finite flag


def _walk(node, path, out) -> None:
    """``(path, leaf)`` for each leaf in JAX's flatten order: dict keys
    sorted, NamedTuple fields by name, sequences by index; None holds no
    leaf."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            _walk(v, path + (f,), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), out)
    else:
        out.append(("/".join(path) or "<root>", node))


def _path_leaves(tree):
    out: list = []
    _walk(tree, (), out)
    return out


def _is_inexact(leaf) -> bool:
    import torch

    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def tree_paths(tree) -> tuple:
    """Slash-joined key path of EVERY leaf, in flatten order."""
    return tuple(p for p, _leaf in _path_leaves(tree))


def leaf_paths(tree) -> tuple:
    """Key paths of the floating leaves only - the tensors a stats pass
    covers, aligned with the :class:`TreeStats` vectors."""
    return tuple(p for p, leaf in _path_leaves(tree)
                 if _is_inexact(leaf))


def _leaf_stats(leaf):
    """(amax, l2, underflow_frac, zero_frac, finite) of one floating
    tensor as 0-d tensors on its device, reduced in fp32 chunk by
    chunk (the squares' partial sums added in float64)."""
    import torch

    tiny = float(torch.finfo(leaf.dtype).tiny)
    flat = leaf.detach().reshape(-1)
    n = flat.numel()
    dev = flat.device
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    sumsq = torch.zeros((), dtype=torch.float64, device=dev)
    under = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for lo in range(0, n, CHUNK_ELEMENTS):
        x = flat[lo:lo + CHUNK_ELEMENTS].float()
        ax = x.abs()
        amax = torch.maximum(amax, ax.max())
        sumsq = sumsq + (x * x).sum().double()
        under = under + ((ax > 0) & (ax < tiny)).sum()
        zero = zero + (x == 0).sum()
        finite = finite & torch.isfinite(x).all()
    denom = float(max(n, 1))
    return (amax, sumsq.sqrt().float(), (under.double() / denom).float(),
            (zero.double() / denom).float(), finite)


def tensor_stats(tree) -> TreeStats:
    """Per-tensor stats for every floating leaf, on the devices the
    leaves live on, stacked on the first leaf's device (the scalars of
    a leaf elsewhere are copied there). No host sync."""
    import torch

    leaves = [leaf for _p, leaf in _path_leaves(tree)
              if _is_inexact(leaf)]
    if not leaves:
        z = torch.zeros((0,), dtype=torch.float32)
        return TreeStats(z, z, z, z, torch.zeros((0,), dtype=torch.bool))
    dev = leaves[0].device
    cols = [[], [], [], [], []]
    for leaf in leaves:
        for col, value in zip(cols, _leaf_stats(leaf)):
            col.append(value.to(dev, non_blocking=True))
    return TreeStats(*(torch.stack(col) for col in cols))


def _fetch(stats: TreeStats):
    """The five vectors on the host, in ONE device-to-host copy."""
    import torch

    packed = torch.stack([v.double() for v in stats]).cpu()
    return packed.tolist()


def host_tensor_stats(tree, stats: Optional[TreeStats] = None) -> dict:
    """{path: {field: float/bool}} for every floating leaf - ONE host
    fetch of the stacked vectors. Pass a precomputed ``stats`` to fetch
    results already computed."""
    paths = leaf_paths(tree)
    if stats is None:
        stats = tensor_stats(tree)
    amax, l2, under, zero, finite = _fetch(stats)
    out = {}
    for i, path in enumerate(paths):
        out[path] = {
            "amax": float(amax[i]),
            "l2": float(l2[i]),
            "underflow_frac": float(under[i]),
            "zero_frac": float(zero[i]),
            "finite": bool(finite[i]),
        }
    return out


def nonfinite_paths(tree, stats: Optional[TreeStats] = None) -> tuple:
    """Key paths of the leaves containing NaN/Inf (one stats pass + one
    fetch for the whole tree)."""
    per_tensor = host_tensor_stats(tree, stats)
    return tuple(p for p, s in per_tensor.items() if not s["finite"])


def summarize_stats(per_tensor: dict, top_k: int = 3) -> dict:
    """Fold a ``host_tensor_stats`` dict into the compact summary a
    step record / JSON line carries: all-finite flag, the non-finite
    paths, and the top-k tensors by amax."""
    import math

    def rank(s):  # non-finite tensors are the most broken: rank first
        return math.inf if not math.isfinite(s["amax"]) else s["amax"]

    worst = sorted(per_tensor.items(), key=lambda kv: -rank(kv[1]))
    return {
        "tensors": len(per_tensor),
        "finite": all(s["finite"] for s in per_tensor.values()),
        "nonfinite_paths": [p for p, s in per_tensor.items()
                            if not s["finite"]],
        # max over FINITE amaxes only - one NaN tensor must not turn
        # the whole summary (and every gauge built on it) into NaN;
        # the finite flag + nonfinite_paths already carry that fact
        "amax_max": max((s["amax"] for s in per_tensor.values()
                         if math.isfinite(s["amax"])), default=0.0),
        "worst_amax": [[p, round(s["amax"], 6)]
                       for p, s in worst[:top_k]],
        "underflow_frac_max": max(
            (s["underflow_frac"] for s in per_tensor.values()),
            default=0.0),
        "zero_frac_max": max((s["zero_frac"]
                              for s in per_tensor.values()),
                             default=0.0),
    }


class StatsCollector:
    """Decimated stats runner: ``observe(tree, step)`` runs the stats
    pass + the single host pull every ``every`` steps and publishes the
    ``numerics/*`` family to the registry; off-cadence steps cost
    nothing.

    Publishes per pull (all labeled ``source=<name>``):

    - gauge ``numerics/finite`` - 1.0/0.0 whole-tree finite flag;
    - gauges ``numerics/amax_max``, ``numerics/underflow_frac_max``,
      ``numerics/zero_frac_max``;
    - timer ``numerics/stats_pass`` - the pass's own cost (compute +
      the one host fetch);
    - counter ``numerics/stats_pulls``; event ``numerics_stats`` with
      the summary (non-finite paths, top-k amax tensors).

    ``last`` keeps the most recent summary - the ``numerics`` block
    ``StepReporter.step(..., numerics=collector.last)`` attaches.
    """

    def __init__(self, name: str = "numerics", every: int = 16,
                 registry=None, top_k: int = 3):
        self.name = name
        self.every = max(int(every), 1)
        self.top_k = top_k
        self._registry = registry
        self.last: Optional[dict] = None

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability.registry import get_registry
        return get_registry()

    def observe(self, tree, step: int) -> Optional[dict]:
        """Run the pass when ``step`` is on cadence; returns the
        summary dict (also kept as ``last``), or None off-cadence."""
        if step % self.every:
            return None
        reg = self._reg()
        timer = reg.timer("numerics/stats_pass", source=self.name)
        timer.start()
        try:
            per_tensor = host_tensor_stats(tree)
        except BaseException:
            timer.cancel()
            raise
        elapsed = timer.stop()  # the host fetch above was the sync
        summary = summarize_stats(per_tensor, top_k=self.top_k)
        summary["step"] = int(step)
        summary["stats_pass_ms"] = round(elapsed * 1e3, 3)
        reg.counter("numerics/stats_pulls", source=self.name).inc()
        reg.gauge("numerics/finite", source=self.name).set(
            1.0 if summary["finite"] else 0.0)
        reg.gauge("numerics/amax_max", source=self.name).set(
            summary["amax_max"])
        reg.gauge("numerics/underflow_frac_max", source=self.name).set(
            summary["underflow_frac_max"])
        reg.gauge("numerics/zero_frac_max", source=self.name).set(
            summary["zero_frac_max"])
        reg.event("numerics_stats", source=self.name, **{
            k: v for k, v in summary.items() if k != "tensors"})
        if not summary["finite"]:
            reg.counter("numerics/nonfinite_pulls",
                        source=self.name).inc()
        self.last = summary
        return summary
