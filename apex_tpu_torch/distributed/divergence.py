"""Replica-divergence detection (port of
``apex_tpu/distributed/divergence.py``).

Values that should be identical on every rank of a group (the params
after a data-parallel step, the loss scaler's state) drift apart after a
missed gradient all-reduce or a non-deterministic reduction, long before
anything turns NaN. Each rank digests its tree into an exact integer
hash of the raw bits and an fp32 magnitude; one collective compares them
across the group.

The digest equals the reference's bit for bit on the same tree: each
element's bits, as uint32, times an odd position weight, summed with
wraparound modulo 2^32. torch has no full uint32 arithmetic, so the port
computes in int64 and keeps the low 32 bits, splitting each product so
that no int64 operation overflows. bf16 and fp8 leaves are read through
``.view`` as 16- and 8-bit integers, never through a cast.

- :func:`replica_divergence`: a 0-dim fp32 tensor, 0.0 iff every rank's
  tree is bit-identical, else the spread of the magnitude digest
  (floored at 1e-30 so that detection is never lost).
- :func:`assert_replicas_equal`: ``(ok, divergence)``.
- :class:`DivergenceMonitor`: the check every ``every`` steps.

The reference runs these inside ``shard_map``; the port runs them on
every rank of the group, which must all call them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend

Axes = Union[str, Sequence[str]]

_MASK = 0xFFFFFFFF
_GOLDEN = 2654435761
# elements digested at once: int64 temporaries of this many elements, and
# sums of this many terms below 2^32 each stay far below 2^63
_CHUNK = 1 << 24


def _leaf_bits(leaf: torch.Tensor) -> torch.Tensor:
    """Raw bits of a leaf as a flat int64 vector of uint32 values (exact,
    dtype-agnostic; ref ``divergence.py:63``)."""
    x = leaf.detach().reshape(-1)
    size = x.element_size()
    if size == 4:
        return x.view(torch.int32).to(torch.int64) & _MASK
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 1:
        return x.view(torch.uint8).to(torch.int64)
    # 8-byte dtypes as a trailing pair of uint32 words (low word first)
    return x.view(torch.int32).to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 tensors of uint32 values, by 16-bit
    halves of ``b`` so that no product passes 2^48."""
    lo = (a * (b & 0xFFFF)) & _MASK
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _leaf_hash(bits: torch.Tensor, i: int) -> int:
    h = 0
    for start in range(0, bits.numel(), _CHUNK):
        part = bits[start:start + _CHUNK]
        pos = torch.arange(start, start + part.numel(), dtype=torch.int64,
                           device=part.device)
        w = (_mul32(pos, torch.tensor(_GOLDEN, device=part.device))
             + (2 * i + 1)) & _MASK
        h = (h + int(_mul32(part, (2 * w + 1) & _MASK).sum())) & _MASK
    return h


def _fingerprint(tree):
    """``(hash, magnitude)`` of a tree (ref ``divergence.py:76``): the
    uint32 position-weighted sum of every leaf's bits as a Python int,
    and the fp32 sum of every element as a 0-dim tensor."""
    leaves = _tree.leaves(tree)
    device = next((t.device for t in leaves), torch.device("cpu"))
    h = 0
    mag = torch.zeros((), dtype=torch.float32, device=device)
    for i, leaf in enumerate(leaves):
        h = (h + _leaf_hash(_leaf_bits(leaf), i)) & _MASK
        mag = mag + leaf.detach().float().sum()
    return h, mag


def _spread(h: int, mag: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """One max-reduction of ``(h, mag, -h, -mag)`` (fp64 holds a uint32
    exactly): 0 where every rank's hash agrees, else the magnitude
    spread, floored at 1e-30."""
    v = torch.stack([torch.tensor(float(h), dtype=torch.float64,
                                  device=mag.device), mag.double()])
    v = backend.all_reduce(torch.cat([v, -v]), backend.ReduceOp.MAX,
                           axis_name)
    h_hi, m_hi, h_lo, m_lo = v[0], v[1], -v[2], -v[3]
    spread = torch.clamp((m_hi - m_lo).abs(), min=1e-30)
    return torch.where(h_hi != h_lo, spread,
                       torch.zeros_like(spread)).float()


def replica_divergence(tree, axis_name: Axes) -> torch.Tensor:
    """0.0 iff every rank of ``axis_name`` holds a bit-identical copy of
    ``tree``, else the spread of the fp32 magnitude digest (ref
    ``divergence.py:97``). One collective of four values after one pass
    over the tree."""
    h, mag = _fingerprint(tree)
    return _spread(h, mag, axis_name)


def assert_replicas_equal(tree, axis_name: Axes, atol: float = 0.0):
    """``(ok, divergence)``: ``ok`` a 0-dim bool tensor, the same on every
    rank (ref ``divergence.py:110``)."""
    div = replica_divergence(tree, axis_name)
    return div <= atol, div


class DivergenceState(NamedTuple):
    step: torch.Tensor            # int32 steps seen
    checks: torch.Tensor          # int32 checks performed
    max_divergence: torch.Tensor  # fp32 worst spread observed
    diverged: torch.Tensor        # bool latch


class DivergenceMonitor:
    """The replicated-state check every ``every`` steps (ref
    ``divergence.py:127``): ``state = monitor.update(state, params,
    "dp")`` on every rank after each step; ``state.diverged`` latches."""

    def __init__(self, every: int = 100, atol: float = 0.0):
        self.every = every
        self.atol = atol

    def init(self) -> DivergenceState:
        return DivergenceState(
            step=torch.zeros((), dtype=torch.int32),
            checks=torch.zeros((), dtype=torch.int32),
            max_divergence=torch.zeros((), dtype=torch.float32),
            diverged=torch.zeros((), dtype=torch.bool))

    def update(self, state: DivergenceState, tree, axis_name: Axes = "dp",
               force: Optional[torch.Tensor] = None) -> DivergenceState:
        """Digest on due steps only. ``due`` is the same on every rank:
        derived from the step, or from ``force`` max-reduced over the
        group (a rank-local force would make one rank digest alone)."""
        step = state.step + 1
        due = bool(step % self.every == 0)
        if force is not None:
            leaves = _tree.leaves(tree)
            device = leaves[0].device if leaves else torch.device("cpu")
            f = backend.all_reduce(
                torch.as_tensor(force, dtype=torch.int32,
                                device=device).reshape(()),
                backend.ReduceOp.MAX, axis_name)
            due = due or bool(f > 0)
        if not due:
            return state._replace(step=step)
        div = replica_divergence(tree, axis_name).cpu()
        return DivergenceState(
            step=step, checks=state.checks + 1,
            max_divergence=torch.maximum(state.max_divergence, div),
            diverged=state.diverged | (div > self.atol))
