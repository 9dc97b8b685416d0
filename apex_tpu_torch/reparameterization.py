"""Weight normalization over param trees (port of
``apex_tpu/reparameterization.py``).

Apex installs forward-pre hooks that recompute w = g * v / ||v||; the
JAX package, and so this port, keeps ``(g, v)`` in the param tree and
makes w inside the forward (:func:`compute_weights`), where autograd
carries the gradient to g and v. :func:`apply_weight_norm` walks nested
dicts and replaces each leaf of two dims or more (or the one named
``name``) ``w`` by ``w_g`` and ``w_v``; a list in the tree is not
walked, as in the reference (apply it to each layer dict of an RNN's
list). The norm is taken in fp32 over every dim but ``dim``, and w comes
back in v's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

_G_SUFFIX = "_g"
_V_SUFFIX = "_v"


def _norm(v, dim: Optional[int]):
    """The fp32 2-norm over every dim but ``dim`` (kept, size 1), or
    over all of ``v`` when ``dim`` is None (``reparameterization.py:
    26``)."""
    v32 = v.float()
    if dim is None:
        return torch.sqrt(torch.sum(v32 ** 2))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v32 ** 2, dim=axes, keepdim=True))


class WeightNorm:
    """w = g * v / ||v|| (``reparameterization.py:36``)."""

    @staticmethod
    def reparameterize(weight, dim: Optional[int] = 0):
        """weight -> (g, v), g the norm in the weight's dtype."""
        return _norm(weight, dim).to(weight.dtype), weight

    @staticmethod
    def compute_weight(g, v, dim: Optional[int] = 0):
        """(g, v) -> w: fp32 arithmetic, ``+1e-12`` under the norm, w in
        v's dtype."""
        w = v.float() * (g.float() / (_norm(v, dim) + 1e-12))
        return w.to(v.dtype)


Reparameterization = WeightNorm


def _eligible(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2


def apply_weight_norm(params, name: str = "", dim: int = 0):
    """Each eligible leaf (every one of two dims or more, or only those
    keyed ``name``) replaced by its ``_g`` and ``_v`` pair
    (``reparameterization.py:61``)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif _eligible(v) and (name == "" or k == name):
                g, vv = WeightNorm.reparameterize(v, dim)
                out[k + _G_SUFFIX] = g
                out[k + _V_SUFFIX] = vv
            else:
                out[k] = v
        return out

    return walk(params)


def compute_weights(params, dim: int = 0):
    """Every ``(w_g, w_v)`` pair made back into ``w``
    (``reparameterization.py:83``): call it inside the forward."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif (k.endswith(_G_SUFFIX)
                  and k[:-len(_G_SUFFIX)] + _V_SUFFIX in node):
                base = k[:-len(_G_SUFFIX)]
                out[base] = WeightNorm.compute_weight(
                    v, node[base + _V_SUFFIX], dim)
            elif (k.endswith(_V_SUFFIX)
                  and k[:-len(_V_SUFFIX)] + _G_SUFFIX in node):
                pass  # taken with its _g
            else:
                out[k] = v
        return out

    return walk(params)


def remove_weight_norm(params, name: str = "", dim: int = 0):
    """The pairs collapsed back into plain weights
    (``reparameterization.py:107``)."""
    del name
    return compute_weights(params, dim)


def _check_kind(reparameterization) -> None:
    if reparameterization is not None and reparameterization is not \
            WeightNorm:
        raise ValueError(
            f"unknown reparameterization {reparameterization!r}; "
            "WeightNorm is the supported kind (as in the reference)")


def apply_reparameterization(params, reparameterization=None, name: str = "",
                             dim: int = 0, hook_child: bool = True):
    """Apply weight norm (the one kind the reference ships) to one named
    weight or every eligible one (``reparameterization.py:113``);
    ``hook_child`` is accepted for parity, there are no hooks."""
    del hook_child
    _check_kind(reparameterization)
    return apply_weight_norm(params, name=name, dim=dim)


def remove_reparameterization(params, reparameterization=None,
                              name: str = "", remove_all: bool = False):
    """Collapse every pair back into plain weights
    (``reparameterization.py:128``); ``name`` and ``remove_all`` are
    accepted for parity, as in the reference."""
    del remove_all
    _check_kind(reparameterization)
    return remove_weight_norm(params, name=name)
