"""Trees of tensors in JAX's leaf order.

``jax.tree_util`` sorts dict keys at every level, so leaf ``i`` here is
leaf ``i`` of the same tree on the JAX side: the flat optimizer slabs and
the gradient lists of the two packages line up by index.

- Nested dicts (the params layout): :func:`paths`, :func:`unflatten`,
  :func:`map_leaves`.
- Any state tree of dicts, lists, tuples, NamedTuples and None
  (:func:`leaves`, :func:`flatten`, :func:`flatten_with_path`,
  :class:`TreeDef`): None is a node with no leaves, anything else a leaf,
  as in ``jax.tree_util``.
  :class:`TreeDef` prints as JAX's ``PyTreeDef`` (``PyTreeDef({'a': [*,
  None], 'o': CustomNode(namedtuple[S], [*])})``) and each leaf's path
  reads as ``jax.tree_util.keystr`` gives it (``['a'][0]``, ``.field``),
  so a checkpoint's ``state_schema`` is the reference's for the same
  state.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Path = Tuple[str, ...]


def paths(tree, prefix: Path = ()) -> List[Path]:
    """The key path of every leaf, keys sorted at every level."""
    if isinstance(tree, dict):
        out: List[Path] = []
        for key in sorted(tree):
            out.extend(paths(tree[key], prefix + (key,)))
        return out
    return [prefix]


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


# ---------------------------------------------------------- any state tree

#: NamedTuple classes whose leaves the schema tags ``"Class.field"``, as
#: the reference's state engine tags its registered constructors
#: (``apex_tpu/analysis/state_checks.py:146``).
TAGGED = ("LossScaleState", "Fp8ScalingState", "AmaxHistoryState",
          "Zero1AdamState")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


class TreeDef:
    """The structure of a tree: ``kind`` is one of ``leaf``, ``none``,
    ``dict``, ``list``, ``tuple``, ``namedtuple``; ``meta`` the sorted
    keys of a dict or the class of a NamedTuple."""

    def __init__(self, kind: str, meta=None, children=()):
        self.kind = kind
        self.meta = meta
        self.children = tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in
                                   zip(self.meta, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if self.kind == "tuple":
            if len(parts) == 1:
                return f"({parts[0]},)"
            return "(" + ", ".join(parts) + ")"
        return (f"CustomNode(namedtuple[{self.meta.__name__}], ["
                + ", ".join(parts) + "])")

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    __repr__ = __str__

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)

    def __hash__(self):
        return hash(str(self))

    def unflatten(self, leaves: Sequence):
        it = iter(leaves)
        tree = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for {self}")
        return tree

    def _build(self, it):
        if self.kind == "leaf":
            value = next(it, _END)
            if value is _END:
                raise ValueError(f"too few leaves for {self}")
            return value
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, kids))
        if self.kind == "list":
            return kids
        if self.kind == "tuple":
            return tuple(kids)
        return self.meta(*kids)


_END = object()


def _walk(node, path: str, tag, out: List[Tuple[str, Any, Any]]
          ) -> TreeDef:
    """Append ``(keystr path, leaf, kind)`` for each leaf under ``node``;
    ``kind`` is the ``"Class.field"`` of the innermost :data:`TAGGED`
    NamedTuple above the leaf, else ``tag``."""
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = sorted(node)
        kids = [_walk(node[k], f"{path}[{k!r}]", tag, out) for k in keys]
        return TreeDef("dict", tuple(keys), kids)
    if _is_namedtuple(node):
        cls = type(node)
        kids = [_walk(v, f"{path}.{f}", f"{cls.__name__}.{f}"
                      if cls.__name__ in TAGGED else tag, out)
                for f, v in zip(cls._fields, node)]
        return TreeDef("namedtuple", cls, kids)
    if isinstance(node, (list, tuple)):
        kids = [_walk(v, f"{path}[{i}]", tag, out)
                for i, v in enumerate(node)]
        return TreeDef("list" if isinstance(node, list) else "tuple",
                       None, kids)
    out.append((path, node, tag))
    return TreeDef("leaf")


def flatten_with_kinds(tree) -> Tuple[List[Tuple[str, Any, Any]], TreeDef]:
    """``([(keystr path, leaf, kind), ...], treedef)`` in JAX's leaf
    order; ``kind`` as in :func:`_walk`, None outside a tagged
    NamedTuple."""
    out: List[Tuple[str, Any, Any]] = []
    treedef = _walk(tree, "", None, out)
    return out, treedef


def flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr path, leaf), ...], treedef)`` in JAX's leaf order."""
    out, treedef = flatten_with_kinds(tree)
    return [(path, leaf) for path, leaf, _ in out], treedef


def flatten(tree) -> Tuple[list, TreeDef]:
    out, treedef = flatten_with_kinds(tree)
    return [leaf for _, leaf, _ in out], treedef


def leaves(tree) -> list:
    """The leaves in JAX's order (for nested dicts, that of
    :func:`paths`)."""
    return flatten(tree)[0]
