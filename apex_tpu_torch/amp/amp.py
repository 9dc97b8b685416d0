"""O1 boundary casting (port of ``apex_tpu/amp/amp.py``).

Apex's O1 patches torch functions at ``amp.initialize``. The port, like
the JAX package, patches nothing in torch: the classification of
:mod:`apex_tpu_torch.amp.lists` is applied where a call goes through
:func:`amp_call` or a function wrapped by :func:`half_function`,
:func:`float_function` or :func:`promote_function`, which cast the
floating tensor arguments per the active O1 policy. With no active
policy every wrapper is the identity.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp.frontend import cast_floats, map_tree

_policy_override = None


def current_policy():
    """The active O1 policy, or None when boundary casting is off: an
    explicit :func:`casting` context first, else the process handle's
    policy when its opt level casts at boundaries (O1)."""
    if _policy_override is not None:
        return _policy_override
    h = _amp_state.handle
    if h is not None and h.props.enabled and h.props.patch_torch_functions:
        return h.policy
    return None


@contextlib.contextmanager
def casting(policy):
    """Force an O1 policy for the duration."""
    global _policy_override
    prev = _policy_override
    _policy_override = policy
    try:
        yield
    finally:
        _policy_override = prev


def _widest_float_dtype(trees) -> Optional[torch.dtype]:
    found = []
    map_tree(lambda t: found.append(t.dtype) if t.is_floating_point()
             else None, trees)
    dtype = None
    for d in found:
        dtype = d if dtype is None else torch.promote_types(dtype, d)
    return dtype


def _cast_call(category, fn, args, kwargs):
    policy = current_policy()
    if policy is None:
        return fn(*args, **kwargs)
    if category == "compute":
        dtype = policy.compute_dtype
    elif category == "fp32":
        dtype = torch.float32
    else:  # promote: the widest floating input wins
        dtype = _widest_float_dtype((args, kwargs))
        if dtype is None:
            return fn(*args, **kwargs)
    return fn(*cast_floats(args, dtype), **cast_floats(kwargs, dtype))


def amp_call(op_name: str, fn, *args, **kwargs):
    """Call ``fn`` with its inputs cast per the O1 policy and the op's
    class in :mod:`apex_tpu_torch.amp.lists`."""
    return _cast_call(lists.classify(op_name), fn, args, kwargs)


def _wrap(fn, category):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return _cast_call(category, fn, args, kwargs)

    wrapper.__wrapped_amp_category__ = category
    return wrapper


def half_function(fn):
    """Inputs cast to the compute (half) dtype under O1."""
    return _wrap(fn, "compute")


def float_function(fn):
    """Inputs cast to fp32 under O1."""
    return _wrap(fn, "fp32")


def promote_function(fn):
    """Inputs widened to the widest floating input dtype under O1."""
    return _wrap(fn, "promote")


def _register(module, name, category):
    fn = getattr(module, name)
    if getattr(fn, "__wrapped_amp_category__", None) == category:
        return  # idempotent
    setattr(module, name, _wrap(fn, category))


def register_half_function(module, function_name):
    """Wrap ``module.function_name`` for compute-dtype casting (the
    port's own modules: torch itself is never patched)."""
    _register(module, function_name, "compute")


def register_float_function(module, function_name):
    _register(module, function_name, "fp32")


def register_promote_function(module, function_name):
    _register(module, function_name, "promote")
