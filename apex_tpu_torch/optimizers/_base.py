"""Stateful optimizer over a functional transform (port of
``apex_tpu/optimizers/_base.py``).

``FusedOptimizer`` wraps a transform with ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` (``fused_adam``,
``fused_lamb``) in Apex's stateful API: it holds the params, the state,
``param_groups`` and ``defaults``, and ``step(grads)`` applies one
update. As in the JAX package, and unlike ``torch.optim``, there are no
``.grad`` attributes: the grads are passed to ``step`` as a tree like the
params, and ``zero_grad`` does nothing. In PyTorch's idiom the params are
updated in place (``p.add_(u)`` in each param's dtype, as
``models._common.train_step`` does) and ``step`` returns them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch import _tree


def _structure(tree):
    """The layout of a state or params tree, for equality checks: a
    NamedTuple's type and fields, a dict's keys, and a tensor's shape and
    dtype (the counterpart of comparing ``jax.tree_util.tree_structure``
    and ``eval_shape`` avals)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,
                tuple((f, _structure(getattr(tree, f)))
                      for f in tree._fields))
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree).__name__


def _on_meta(tree):
    """``tree`` with every tensor replaced by an empty one of its shape
    and dtype on the meta device: a transform's ``init`` over it builds
    the state's layout without allocating it (``jax.eval_shape``)."""
    return _tree.map_leaves(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _apply_updates(params, updates) -> None:
    with torch.no_grad():
        for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
            p.add_(u)


class FusedOptimizer:
    """Apex-style stateful wrapper: holds params and state, ``step(grads)``.

    ``tx_factory(**overrides)`` rebuilds the transform with some
    hyperparameters changed; it serves per-group overrides
    (:meth:`add_param_group`) and live edits of ``param_groups[i]``
    (an LR scheduler writing ``group["lr"]``), which rebuild that group's
    transform at the next :meth:`step`.
    """

    def __init__(self, params, tx, defaults: dict,
                 tx_factory: Optional[Callable] = None):
        self.defaults = dict(defaults)
        self.tx = tx
        self._tx_factory = tx_factory
        self.params = params
        self.state = tx.init(params)
        # group 0 aliases (params, state) above; groups added later carry
        # their own transform and state
        self.param_groups = [{"params": params, **self.defaults}]
        self._group_hparams = [dict(self.defaults)]
        self._extra_groups = []

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, tree) -> None:
        """The params of group 0; ``param_groups[0]["params"]`` follows a
        reassignment (amp's O2 protocol reassigns them), so no stale tree
        stays alive through it."""
        self._params = tree
        if getattr(self, "param_groups", None):
            self.param_groups[0]["params"] = tree

    def add_param_group(self, group: dict) -> None:
        """Add a parameter group with its own hyperparameters:
        ``{"params": tree, **overrides}``; unknown hyperparameters are
        rejected. With extra groups, ``step`` takes a list of grad trees,
        one per group in order."""
        if not isinstance(group, dict) or "params" not in group:
            raise ValueError("param group must be a dict with a 'params' key")
        overrides = {k: v for k, v in group.items() if k != "params"}
        unknown = set(overrides) - set(self.defaults)
        if unknown:
            raise ValueError(f"unknown hyperparameters for this optimizer: "
                             f"{sorted(unknown)}")
        if overrides and self._tx_factory is None:
            raise ValueError(
                "this optimizer does not support per-group overrides")
        tx = self._tx_factory(**overrides) if overrides else self.tx
        gparams = group["params"]
        self._extra_groups.append({"params": gparams,
                                   "state": tx.init(gparams), "tx": tx})
        self.param_groups.append({**self.defaults, **group})
        self._group_hparams.append({**self.defaults, **overrides})

    def _group_state(self, i: int):
        return self.state if i == 0 else self._extra_groups[i - 1]["state"]

    def _sync_group_hparams(self) -> None:
        """Rebuild the transform of every group whose hyperparameters in
        ``param_groups`` changed since the last step. The state carries
        over, so a rebuild that changes its layout raises."""
        for i, pg in enumerate(self.param_groups):
            current = {k: pg[k] for k in self.defaults if k in pg}
            if current == self._group_hparams[i]:
                continue
            if self._tx_factory is None:
                raise ValueError(
                    "param_groups hyperparameters changed but this "
                    "optimizer has no tx_factory to rebuild from")
            changed = {k: v for k, v in current.items()
                       if v != self.defaults.get(k)}
            tx = self._tx_factory(**changed)
            new_struct = _structure(tx.init(_on_meta(pg["params"])))
            old_struct = _structure(self._group_state(i))
            if new_struct != old_struct:
                raise ValueError(
                    f"param_groups[{i}] hyperparameter change altered the "
                    f"optimizer state structure ({old_struct} -> "
                    f"{new_struct}); carried state cannot be reused: "
                    f"rebuild the optimizer instead")
            if i == 0:
                self.tx = tx
            else:
                self._extra_groups[i - 1]["tx"] = tx
            self._group_hparams[i] = current

    @staticmethod
    def _update(tx, grads, state, params):
        with torch.no_grad():
            updates, state = tx.update(grads, state, params)
            _apply_updates(params, updates)
        return state

    def step(self, grads=None, closure: Optional[Callable] = None):
        """Apply one update in place. Returns the params (a list of the
        groups' params with extra groups), or ``closure()``'s loss when a
        closure is given. With extra groups ``grads`` is a list of trees,
        one per group."""
        loss = closure() if closure is not None else None
        if grads is None:
            raise ValueError(
                "apex_tpu_torch optimizers are functional: pass grads to "
                "step() (no .grad attribute is read).")
        self._sync_group_hparams()
        if not self._extra_groups:
            self.state = self._update(self.tx, grads, self.state,
                                      self.params)
            return loss if loss is not None else self.params
        if not isinstance(grads, (list, tuple)):
            raise ValueError(
                f"optimizer has {1 + len(self._extra_groups)} param groups: "
                "pass a list of grad trees, one per group")
        grads = list(grads)
        if len(grads) != 1 + len(self._extra_groups):
            raise ValueError(
                f"expected {1 + len(self._extra_groups)} grad trees "
                f"(one per param group), got {len(grads)}")
        self.state = self._update(self.tx, grads[0], self.state,
                                  self.params)
        for g, grp in zip(grads[1:], self._extra_groups):
            grp["state"] = self._update(grp["tx"], g, grp["state"],
                                        grp["params"])
        all_params = [self.params] + [g["params"] for g in self._extra_groups]
        return loss if loss is not None else all_params

    def zero_grad(self, set_to_none: bool = True):  # noqa: ARG002 - parity
        return None

    def state_dict(self) -> dict:
        d = {"state": self.state, "defaults": self.defaults}
        if self._extra_groups:
            d["group_states"] = [g["state"] for g in self._extra_groups]
        return d

    def load_state_dict(self, state_dict: dict) -> None:
        new_state = state_dict["state"]
        have, got = _structure(self.state), _structure(new_state)
        if have != got:
            raise ValueError(
                f"loaded optimizer state structure {got} does not match "
                f"current optimizer structure {have}")
        group_states = state_dict.get("group_states", [])
        if len(group_states) != len(self._extra_groups):
            raise ValueError(
                f"loaded state has {len(group_states)} extra param groups, "
                f"optimizer has {len(self._extra_groups)}")
        for i, (grp, s) in enumerate(zip(self._extra_groups, group_states)):
            have, got = _structure(grp["state"]), _structure(s)
            if have != got:
                raise ValueError(
                    f"loaded state for param group {i + 1} has structure "
                    f"{got}, optimizer has {have}")
        self.state = new_state
        for grp, s in zip(self._extra_groups, group_states):
            grp["state"] = s
        self.defaults.update(state_dict.get("defaults", {}))


def _replicated_specs(node):
    """``node`` with each tensor replaced by the replicated spec ``()``."""
    if isinstance(node, torch.Tensor):
        return ()
    if isinstance(node, dict):
        return {k: _replicated_specs(v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(type(node), "_fields"):
        return type(node)(*[_replicated_specs(v) for v in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_replicated_specs(v) for v in node)
    return node


def opt_partition_specs(tx, params, param_specs):
    """Partition specs of ``tx.init(params)``'s state (``_base.py:199``)
    whose moment trees mirror the params' sharding: the Fused*
    ``(count, mu, nu)`` states get ``mu=param_specs, nu=param_specs``,
    every other leaf (the counter, a ``flat=True`` state's dtype-keyed
    slabs, which do not mirror the params) replicates. A spec is the
    port's per-leaf form of a ``PartitionSpec``: a tuple with one entry a
    dim (an axis name, a tuple of names, or None), ``()`` replicated.
    The state's structure is read from ``tx.init`` on meta tensors, so
    nothing is allocated."""
    meta = _tree.map_leaves(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    shapes = tx.init(meta)
    specs = _replicated_specs(shapes)
    if hasattr(specs, "_replace") and hasattr(specs, "mu"):
        mirrors = (isinstance(shapes.mu, dict)
                   and _tree.paths(shapes.mu) == _tree.paths(params)
                   and all(isinstance(m, torch.Tensor)
                           and tuple(m.shape) == tuple(p.shape)
                           for m, p in zip(_tree.leaves(shapes.mu),
                                           _tree.leaves(params))))
        if mirrors:
            specs = specs._replace(mu=param_specs, nu=param_specs)
    return specs
