"""Flat-buffer packing (port of ``apex_tpu/ops/flat.py``).

The flat optimizer path packs every parameter into one 1-D buffer per
dtype, so one kernel launch updates the whole model whatever its number
of tensors. Leaves go in JAX's order (dict keys sorted at every level)
and buffers are keyed by the dtype names JAX uses (``"bfloat16"``,
``"float32"``), so a flat m/v slab of the JAX package converts to the
port's by key and offset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch import _tree


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """How a list of same-dtype tensors packs into one buffer."""

    shapes: tuple  # tuple of shape-tuples
    dtype: torch.dtype
    offsets: tuple  # start offset of each leaf in the flat buffer
    sizes: tuple
    total: int

    @staticmethod
    def of(tensors: Sequence[torch.Tensor]) -> "FlatSpec":
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) > 1:
            raise ValueError(f"flatten_tensors requires a uniform dtype, "
                             f"got {dtypes}; split into per-dtype lists "
                             f"first")
        shapes = tuple(tuple(t.shape) for t in tensors)
        sizes = tuple(t.numel() for t in tensors)
        offsets, total = [], 0
        for size in sizes:
            offsets.append(total)
            total += size
        return FlatSpec(shapes=shapes,
                        dtype=dtypes.pop() if dtypes else torch.float32,
                        offsets=tuple(offsets), sizes=sizes, total=total)


def flatten_tensors(tensors: Sequence[torch.Tensor],
                    spec: Optional[FlatSpec] = None,
                    dtype: Optional[torch.dtype] = None):
    """Pack same-dtype tensors into one new 1-D buffer (in ``dtype``,
    default the tensors' own), leaf by leaf with no temporaries."""
    if spec is None:
        spec = FlatSpec.of(tensors)
    device = tensors[0].device if tensors else None
    flat = torch.empty((spec.total,), dtype=dtype or spec.dtype,
                       device=device)
    for t, off, size in zip(tensors, spec.offsets, spec.sizes):
        flat[off:off + size].copy_(t.reshape(-1))
    return flat, spec


def unflatten_tensors(flat: torch.Tensor, spec: FlatSpec) -> List:
    """Views of ``flat``, one per leaf (inverse of
    :func:`flatten_tensors`)."""
    return [flat[off:off + size].view(shape)
            for off, size, shape in zip(spec.offsets, spec.sizes,
                                        spec.shapes)]


def tree_meta(tree) -> Tuple:
    """``(paths, n_leaves, {dtype name: (leaf indices, FlatSpec)})`` of
    a nested dict of tensors, without packing anything."""
    leaves = _tree.leaves(tree)
    by_dtype: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
    specs = {name: (tuple(idxs), FlatSpec.of([leaves[i] for i in idxs]))
             for name, idxs in by_dtype.items()}
    return _tree.paths(tree), len(leaves), specs


def flatten_tree(tree):
    """Pack a nested dict of tensors into per-dtype flat buffers.

    Returns ``(buffers, (paths, n_leaves, specs))`` with ``buffers`` a
    dict from dtype name to 1-D buffer (counterpart of
    ``apex_tpu.ops.flat.flatten_tree``)."""
    meta = tree_meta(tree)
    leaves = _tree.leaves(tree)
    buffers = {name: flatten_tensors([leaves[i] for i in idxs], spec)[0]
               for name, (idxs, spec) in meta[2].items()}
    return buffers, meta


def unflatten_tree(buffers, meta):
    """Inverse of :func:`flatten_tree`; the leaves are views of the
    buffers."""
    leaf_paths, n_leaves, specs = meta
    leaves: list = [None] * n_leaves
    for name, (idxs, spec) in specs.items():
        for i, part in zip(idxs, unflatten_tensors(buffers[name], spec)):
            leaves[i] = part
    return _tree.unflatten(leaf_paths, leaves)
