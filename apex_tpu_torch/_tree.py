"""Nested dicts of tensors as pytrees, in JAX's leaf order.

``jax.tree_util`` sorts dict keys at every level, so leaf ``i`` here is
leaf ``i`` of the same tree on the JAX side: the flat optimizer slabs and
the gradient lists of the two packages line up by index.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

Path = Tuple[str, ...]


def paths(tree, prefix: Path = ()) -> List[Path]:
    """The key path of every leaf, keys sorted at every level."""
    if isinstance(tree, dict):
        out: List[Path] = []
        for key in sorted(tree):
            out.extend(paths(tree[key], prefix + (key,)))
        return out
    return [prefix]


def leaves(tree) -> list:
    """The leaves in the order of :func:`paths`."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [tree]


def unflatten(leaf_paths: Sequence[Path], values: Sequence) -> Dict:
    """Nested dicts with ``values[i]`` at ``leaf_paths[i]``."""
    if len(leaf_paths) != len(values):
        raise ValueError(f"{len(values)} values for {len(leaf_paths)} "
                         f"leaves")
    if list(leaf_paths) == [()]:
        return values[0]
    root: Dict = {}
    for path, value in zip(leaf_paths, values):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return root


def map_leaves(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {key: map_leaves(fn, value) for key, value in tree.items()}
    return fn(tree)
