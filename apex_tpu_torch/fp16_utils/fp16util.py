"""Half-precision helpers over param trees (port of
``apex_tpu/fp16_utils/fp16util.py``).

Apex mutates ``torch.nn`` modules in place; the JAX package, and so this
port, maps trees of tensors (nested dicts, lists, tuples): "the model"
is ``(apply_fn, params)``, and half precision is a low-precision copy of
the params, with fp32 masters kept for the update (``prep_param_lists``).
Every helper returns a new tree and leaves non-float leaves as they are.
The half dtype defaults to bfloat16, as in the reference; fp16 works
too.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import torch

from apex_tpu_torch import _tree

_BATCHNORM = re.compile(
    r"(^|[\[\]'/._])(bn\d*|batchnorm\d*|batch_stats|"
    r"batchnorm|syncbatchnorm)([\]\['/._]|$)")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and torch.is_floating_point(x)


def _map(fn: Callable, tree):
    leaves, treedef = _tree.flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])


def _cast(dtype):
    return lambda p: p.to(dtype) if _is_float(p) else p


def tofp16(params, half_dtype=torch.bfloat16):
    """Every floating leaf cast to ``half_dtype`` (``fp16util.py:28``)."""
    return _map(_cast(half_dtype), params)


def BN_convert_float(params, is_batchnorm: Optional[Callable] = None):
    """Batchnorm leaves back to fp32 (``fp16util.py:34``). A leaf is a
    batchnorm's when ``is_batchnorm`` of its key path (as
    ``jax.tree_util.keystr`` spells it, ``"['bn1']['scale']"``) is true;
    by default, when a segment of the path is ``bn``, ``bn<k>``,
    ``batchnorm``, ``batch_stats`` or ``syncbatchnorm`` (any case)."""
    if is_batchnorm is None:
        def is_batchnorm(path: str) -> bool:
            return _BATCHNORM.search(path.lower()) is not None

    pairs, treedef = _tree.flatten_with_path(params)
    return treedef.unflatten([
        leaf.to(torch.float32) if _is_float(leaf) and is_batchnorm(path)
        else leaf for path, leaf in pairs])


def network_to_half(params, half_dtype=torch.bfloat16):
    """Half-cast params, batchnorm kept fp32 (``fp16util.py:56``)."""
    return BN_convert_float(tofp16(params, half_dtype))


def convert_module(params, dtype):
    """A (sub)tree's float leaves cast to ``dtype``
    (``fp16util.py:61``)."""
    return _map(_cast(dtype), params)


def convert_network(params, dtype):
    """:func:`convert_module` with batchnorm kept fp32
    (``fp16util.py:67``)."""
    return BN_convert_float(convert_module(params, dtype))


class FP16Model:
    """``(apply_fn, params)`` run in half precision with fp32 batchnorm
    (``fp16util.py:72``): the params are cast once, float inputs at each
    call."""

    def __init__(self, apply_fn: Callable, params,
                 half_dtype=torch.bfloat16):
        self.apply_fn = apply_fn
        self.half_dtype = half_dtype
        self.params = network_to_half(params, half_dtype)

    def __call__(self, *inputs, **kw):
        cast = [x.to(self.half_dtype) if _is_float(x) else x
                for x in inputs]
        return self.apply_fn(self.params, *cast, **kw)


def _flat_floats(tree) -> torch.Tensor:
    """The float leaves raveled and joined into one fp32 vector."""
    parts = [leaf.reshape(-1).to(torch.float32)
             for leaf in _tree.leaves(tree) if _is_float(leaf)]
    if not parts:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(parts)


def prep_param_lists(params, flat_master: bool = False):
    """``(model_params, master_params)`` (``fp16util.py:88``): the model
    tree as given, and an fp32 copy of it (a copy even of fp32 leaves:
    the optimizer updates the masters in place). ``flat_master=True``
    joins the float leaves into one fp32 vector, the layout a flat
    optimizer takes; only float leaves are packed."""
    if flat_master:
        return params, _flat_floats(params)
    return params, _map(
        lambda p: p.detach().to(torch.float32, copy=True) if _is_float(p)
        else p, params)


def model_grads_to_master_grads(model_grads, master_params=None,
                                flat_master: bool = False):
    """The grads in fp32, joined into one vector with ``flat_master``
    (``fp16util.py:104``)."""
    del master_params
    if flat_master:
        return _flat_floats(model_grads)
    return _map(lambda g: g.float() if _is_float(g) else g, model_grads)


def master_params_to_model_params(model_params, master_params,
                                  flat_master: bool = False):
    """A new model tree: each float leaf the master rounded to the
    leaf's dtype (``fp16util.py:117``); with ``flat_master`` the masters
    are one vector, read in leaf order."""
    leaves, treedef = _tree.flatten(model_params)
    if flat_master:
        out, off = [], 0
        for leaf in leaves:
            if _is_float(leaf):
                n = leaf.numel()
                out.append(master_params[off:off + n].reshape(leaf.shape)
                           .to(leaf.dtype))
                off += n
            else:
                out.append(leaf)
        return treedef.unflatten(out)
    masters = _tree.leaves(master_params)
    return treedef.unflatten([m.to(p.dtype) if _is_float(p) else p
                              for m, p in zip(masters, leaves)])


def to_python_float(t) -> float:
    """A 0-dim or one-element tensor, or a Python number, as a float
    (``fp16util.py:138``)."""
    if isinstance(t, torch.Tensor):
        return float(t.reshape(()))
    return float(t)


def clip_grad_norm(grads, max_norm: float, norm_type: float = 2.0):
    """``(clipped, total_norm)``: the tree's global norm of order
    ``norm_type`` (inf: the largest magnitude) and every float leaf
    scaled by ``min(1, max_norm / (total + 1e-6))`` in its dtype
    (``fp16util.py:143``). The sums are taken in fp32 whatever the
    leaves' dtype."""
    floats = [g for g in _tree.leaves(grads) if _is_float(g)]
    if norm_type == float("inf"):
        total = torch.amax(torch.stack(
            [torch.amax(torch.abs(g.float())) for g in floats]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(g.float()) ** norm_type) for g in floats])
        ) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype) if _is_float(g) else g,
                grads), total
