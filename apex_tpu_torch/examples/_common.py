"""What the port's examples share (counterpart of ``examples/_common.py``):
cutting a rank's block out of full params by their partition specs, and
applying an optimizer's update in place."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend

Coords = Dict[str, Tuple[int, int]]


def coords_of(axes) -> Coords:
    """axis -> (this rank's index, the axis's size), each axis bound."""
    return {a: (_backend.get_rank(a), _backend.get_world_size(a))
            for a in axes}


def block(full: torch.Tensor, spec, coords: Coords) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (one entry a dim: an
    axis name or None), a view; an axis missing from ``coords`` is
    whole."""
    out = full
    for dim, axis in enumerate(spec):
        if axis in coords:
            r, n = coords[axis]
            size = full.shape[dim] // n
            out = out.narrow(dim, r * size, size)
    return out


def shard(full: torch.Tensor, spec, coords: Coords) -> torch.Tensor:
    """:func:`block`, a copy."""
    return block(full, spec, coords).clone()


def shard_tree(tree, specs, coords: Coords):
    """:func:`shard` of every leaf of a nested dict, ``specs`` the same
    nesting (the reference's ``shard_map`` in_specs)."""
    return {k: (shard_tree(v, specs[k], coords) if isinstance(v, dict)
                else shard(v, specs[k], coords)) for k, v in tree.items()}


@torch.no_grad()
def apply_updates(tx, params, opt_state, grads):
    """``tx``'s update of ``params`` from ``grads``, added in place;
    returns the new optimizer state."""
    updates, opt_state = tx.update(grads, opt_state, params)
    for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
        p.add_(u)
    return opt_state
