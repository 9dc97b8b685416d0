"""Parity of the port's FusedSGD (``apex_tpu_torch.optimizers.fused_sgd``)
with the JAX package's over 3 steps, from the same numpy params and
gradients, in every branch: momentum {0, 0.9} x nesterov x dampening x
``wd_after_momentum`` x a constant or scheduled learning rate, the
first-run seed of the buffer, and the ``ValueError`` nesterov raises
without momentum or with dampening. Both sides run the same elementwise
fp32 arithmetic: updates, buffers and params agree to 1e-6 relative
(1e-7 absolute).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers import FusedSGD, FusedSGDState, fused_sgd

RTOL, ATOL = 1e-6, 1e-7


def _tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": {"bias": (scale * rng.standard_normal(7)).astype(
                np.float32)},
            "c": (scale * rng.standard_normal((4, 3))).astype(np.float32)}


def _to_torch(tree):
    return _tree.map_leaves(torch.from_numpy, tree)


def _assert_tree_close(port_tree, jax_tree, what):
    for path, ref in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = port_tree
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(
            node.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _lr(kind):
    """A constant, or a schedule of the pre-increment count (the same
    function of an int tensor on both sides)."""
    return 0.1 if kind == "const" else (lambda count: 0.1 * 0.5 ** count)


CASES = list(itertools.product((0.0, 0.9), (False, True), (0.0, 0.1),
                               (False, True), ("const", "schedule")))


@pytest.mark.parametrize("momentum,nesterov,dampening,wd_after,lr", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_three_sgd_steps_match_jax(momentum, nesterov, dampening, wd_after,
                                   lr):
    kw = dict(momentum=momentum, dampening=dampening, nesterov=nesterov,
              weight_decay=0.01, wd_after_momentum=wd_after)
    if nesterov and (momentum <= 0 or dampening != 0):
        for make in (jax_fused_sgd, fused_sgd):
            with pytest.raises(ValueError, match="Nesterov"):
                make(lr=_lr(lr), **kw)
        return
    jtx, tx = jax_fused_sgd(lr=_lr(lr), **kw), fused_sgd(lr=_lr(lr), **kw)
    params = _tree_np(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    p = _to_torch(params)
    state = tx.init(p)
    for step in range(3):
        grads = _tree_np(10 + step, 2.0)
        jupd, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        upd, state = tx.update(_to_torch(grads), state, p)
        _assert_tree_close(upd, jupd, f"step {step} update")
        _assert_tree_close(state.momentum_buffer, jstate.momentum_buffer,
                           f"step {step} buffer")
        jp = jax.tree_util.tree_map(jnp.add, jp, jupd)
        for leaf, u in zip(_tree.leaves(p), _tree.leaves(upd)):
            leaf.add_(u)
    assert isinstance(state, FusedSGDState)
    assert int(state.count) == int(jstate.count) == 3
    _assert_tree_close(p, jp, "params")


def test_first_run_seeds_the_buffer_with_the_raw_gradient():
    """Step 1's buffer is the gradient itself, not (1 - dampening) of it;
    a bf16 param gets its update in bf16, the buffer in fp32."""
    tx = fused_sgd(lr=0.1, momentum=0.9, dampening=0.5)
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.arange(4, dtype=torch.float32)}
    upd, state = tx.update(g, tx.init(p), p)
    assert torch.equal(state.momentum_buffer["w"], g["w"])
    assert state.momentum_buffer["w"] is not g["w"]
    assert upd["w"].dtype == torch.bfloat16
    _, state = tx.update(g, state, p)
    torch.testing.assert_close(state.momentum_buffer["w"],
                               0.9 * g["w"] + 0.5 * g["w"])


def test_stateful_fused_sgd_matches_jax():
    """``FusedSGD(params, ...).step(grads)`` (the reference's
    ``materialize_master_grads`` and ``set_grad_none`` accepted)."""
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, nesterov=True,
              materialize_master_grads=False, set_grad_none=True)
    params = _tree_np(1)
    jopt = JFusedSGD(jax.tree_util.tree_map(jnp.asarray, params), **kw)
    opt = FusedSGD(_to_torch(params), **kw)
    assert opt.defaults == dict(lr=0.05, momentum=0.9, dampening=0.0,
                                weight_decay=1e-3, nesterov=True)
    for step in range(3):
        grads = _tree_np(20 + step)
        jopt.step(jax.tree_util.tree_map(jnp.asarray, grads))
        opt.step(_to_torch(grads))
    _assert_tree_close(opt.params, jopt.params, "params")
