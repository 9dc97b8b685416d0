"""Parity of the port's functional FusedLAMB
(apex_tpu_torch.optimizers.fused_lamb) with the JAX package's over 3
steps, from the same numpy params and gradients: updates and the fp32
moments. Both sides compute in fp32 and differ in summation order only
(the global and per-tensor norms): updates and state agree to 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import (
    multi_tensor_l2norm as jax_l2norm,
)
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import _tree
from apex_tpu_torch.multi_tensor_apply import multi_tensor_l2norm
from apex_tpu_torch.optimizers import fused_lamb
from apex_tpu_torch.optimizers.fused_lamb import opt_state_from_numpy

RTOL, ATOL = 1e-5, 1e-7


def _tree_np(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": {"bias": (scale * rng.standard_normal(7)).astype(
                np.float32),
                  "zero": np.zeros(3, np.float32)},
            "c": (scale * rng.standard_normal((4, 2, 3))).astype(np.float32)}


def _to_torch(tree):
    return _tree.map_leaves(torch.from_numpy, tree)


def _assert_tree_close(port_tree, jax_tree, what):
    for path, ref in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = port_tree
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("kw", [
    dict(),                                        # clipping on (norm > 1)
    dict(max_grad_norm=0.0),                       # clipping off
    dict(max_grad_norm=1e3),                       # norm below the bound
    dict(weight_decay=0.0, use_nvlamb=True),       # NVLAMB: ratio kept
    dict(weight_decay=0.0),                        # NVLAMB off: ratio 1
    dict(adam_w_mode=False, grad_averaging=False, bias_correction=False),
], ids=["clip", "noclip", "under", "nvlamb", "no_nvlamb", "l2"])
def test_three_lamb_steps_match_jax(kw):
    params = _tree_np(0, 1.0)
    jtx = jax_fused_lamb(lr=1e-2, **kw)
    tx = fused_lamb(lr=1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    p = _to_torch(params)
    state = tx.init(p)
    for step in range(3):
        grads = _tree_np(10 + step, 3.0)  # global norm ~ 25: clipped at 1
        jupd, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        upd, state = tx.update(_to_torch(grads), state, p)
        _assert_tree_close(upd, jupd, f"step {step} update")
        jp = jax.tree_util.tree_map(jnp.add, jp, jupd)
        for leaf, u in zip(_tree.leaves(p), _tree.leaves(upd)):
            leaf.add_(u)
    assert int(state.count) == int(jstate.count) == 3
    _assert_tree_close(state.mu, jstate.mu, "mu")
    _assert_tree_close(state.nu, jstate.nu, "nu")
    _assert_tree_close(p, jp, "params")


def test_bf16_params_get_bf16_updates_and_fp32_state():
    params = _tree.map_leaves(lambda a: a.to(torch.bfloat16),
                              _to_torch(_tree_np(1, 1.0)))
    tx = fused_lamb()
    state = tx.init(params)
    upd, state = tx.update(params, state, params)
    assert all(u.dtype == torch.bfloat16 for u in _tree.leaves(upd))
    assert all(m.dtype == torch.float32 for m in _tree.leaves(state.mu))


def test_multi_tensor_l2norm_matches_jax():
    tensors = list(_tree_np(4, 2.0).values())
    flat = [tensors[0], tensors[1]["bias"], tensors[2]]
    total, per = multi_tensor_l2norm([torch.from_numpy(t) for t in flat],
                                     per_tensor=True)
    ref_total, ref_per = jax_l2norm([jnp.asarray(t) for t in flat],
                                    per_tensor=True)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    np.testing.assert_allclose(per.numpy(), np.asarray(ref_per), rtol=1e-6)
    assert multi_tensor_l2norm([torch.from_numpy(flat[0])])[1] is None


def test_opt_state_from_numpy_carries_the_jax_state():
    params = _tree_np(2, 1.0)
    jtx = jax_fused_lamb()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray,
                                                  _tree_np(3, 1.0)),
                           jtx.init(jp), jp)
    state = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    assert int(state.count) == 1 and state.count.dtype == torch.int32
    _assert_tree_close(state.mu, jstate.mu, "mu")
    _assert_tree_close(state.nu, jstate.nu, "nu")
