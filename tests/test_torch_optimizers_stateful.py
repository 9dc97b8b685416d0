"""Parity of the port's stateful optimizers (apex_tpu_torch.optimizers
FusedOptimizer, FusedAdam, FusedLAMB) with the JAX package's classes.

Params and per-step grads come from numpy with a fixed seed; the tree
holds fp32 leaves and one bf16 leaf (flat mode packs a slab of each).
Both sides run the same elementwise fp32 update; XLA may contract a * b
+ c into one FMA where the port rounds the product first, so fp32 params
and state agree to RTOL/ATOL (a few ulps, the tolerance of
test_torch_fused_adam.py) and bf16 params within one bf16 ulp. The port
updates its params in place and returns them; the JAX classes return new
trees. Every error path of the reference class is held too.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch import _tree
from apex_tpu_torch import optimizers as port_opt
from apex_tpu_torch.optimizers import (
    FusedAdam,
    FusedLAMB,
    FusedOptimizer,
    fused_adam,
    opt_state_from_numpy,
)

RTOL, ATOL = 1e-5, 2e-7
BF16_RTOL = 2 ** -7  # one bf16 ulp of the value
STEPS = 3


def _np_tree(seed, bf16=True):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"w": arr(4, 3), "b": {"z": arr(5), "a": arr(2, 3)}}
    if bf16:
        tree["h_bf16"] = arr(7)
    return tree


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(
        v, jnp.bfloat16 if k.endswith("bf16") else jnp.float32)
        for k, v in tree.items()}


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(
        v.copy()).to(torch.bfloat16 if k.endswith("bf16") else torch.float32)
        for k, v in tree.items()}


def _grads(seed, step, bf16=True):
    tree = _np_tree(1000 + 17 * seed + step, bf16)
    return _jax(tree), _port(tree)


def _assert_close(port_tree, jax_tree, what):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(_tree.leaves(port_tree)), what
    for path, ref in flat:
        node = port_tree
        for key in path:
            node = node[key.key]
        got = node.detach().float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        bf16 = node.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got, ref, rtol=BF16_RTOL if bf16 else RTOL,
            atol=0 if bf16 else ATOL,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_state_close(port_state, jax_state, what):
    assert int(port_state.count) == int(jax_state.count), what
    assert port_state.count.dtype == torch.int32
    _assert_close(port_state.mu, jax_state.mu, what + ".mu")
    _assert_close(port_state.nu, jax_state.nu, what + ".nu")


CLASSES = {
    "adam_tree": (FusedAdam, JaxFusedAdam, dict(lr=1e-2, weight_decay=0.01)),
    "adam_flat": (FusedAdam, JaxFusedAdam,
                  dict(lr=1e-2, weight_decay=0.01, flat=True)),
    "adam_l2": (FusedAdam, JaxFusedAdam,
                dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False)),
    "lamb": (FusedLAMB, JaxFusedLAMB, dict(lr=1e-2, weight_decay=0.01)),
    "lamb_nvlamb": (FusedLAMB, JaxFusedLAMB,
                    dict(lr=1e-2, weight_decay=0.0, use_nvlamb=True,
                         max_grad_norm=0.5)),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_three_steps_match_jax(case):
    port_cls, jax_cls, kw = CLASSES[case]
    tree = _np_tree(0)
    jopt, popt = jax_cls(_jax(tree), **kw), port_cls(_port(tree), **kw)
    for step in range(STEPS):
        jg, pg = _grads(0, step)
        jparams = jopt.step(jg)
        pparams = popt.step(pg)
        assert pparams is popt.params  # updated in place, returned
        _assert_close(pparams, jparams, f"{case} step {step} params")
    _assert_state_close(popt.state, jopt.state, case)


def test_second_param_group_with_lr_override():
    """Two groups evolve as two optimizers, each with its own lr and
    weight decay (JAX's test_param_groups)."""
    t0, t1 = _np_tree(0, bf16=False), _np_tree(1, bf16=False)
    jopt = JaxFusedAdam(_jax(t0), lr=1e-3)
    jopt.add_param_group({"params": _jax(t1), "lr": 3e-3,
                          "weight_decay": 0.1})
    popt = FusedAdam(_port(t0), lr=1e-3)
    popt.add_param_group({"params": _port(t1), "lr": 3e-3,
                          "weight_decay": 0.1})
    assert popt.param_groups[1]["lr"] == 3e-3
    for step in range(STEPS):
        (jg0, pg0), (jg1, pg1) = (_grads(0, step, False),
                                  _grads(1, step, False))
        j0, j1 = jopt.step([jg0, jg1])
        p0, p1 = popt.step([pg0, pg1])
        _assert_close(p0, j0, f"group 0 step {step}")
        _assert_close(p1, j1, f"group 1 step {step}")


@pytest.mark.parametrize("flat", [False, True])
def test_live_lr_edit_rebuilds_the_transform(flat):
    """A scheduler writing param_groups[0]["lr"] between steps takes
    effect at the next step, the state carried over."""
    tree = _np_tree(2)
    jopt = JaxFusedAdam(_jax(tree), lr=1e-2, flat=flat)
    popt = FusedAdam(_port(tree), lr=1e-2, flat=flat)
    for step in range(STEPS):
        if step:
            jopt.param_groups[0]["lr"] = popt.param_groups[0]["lr"] = (
                1e-2 / (step + 1))
        jg, pg = _grads(2, step)
        _assert_close(popt.step(pg), jopt.step(jg), f"step {step}")
    assert popt.tx is not None and popt._group_hparams[0]["lr"] == 1e-2 / 3
    _assert_state_close(popt.state, jopt.state, "after edits")


@pytest.mark.parametrize("cls,kw", [(FusedAdam, {}),
                                    (FusedAdam, {"flat": True}),
                                    (FusedLAMB, {})])
def test_state_dict_round_trip(cls, kw):
    """A state_dict (copied, as a save would: like torch.optim's, it
    holds the live tensors, and flat mode updates its m/v slabs in
    place) loads into a fresh optimizer, which then steps as the
    original does."""
    tree = _np_tree(3)
    a, b = cls(_port(tree), lr=1e-2, **kw), cls(_port(tree), lr=1e-2, **kw)
    a.add_param_group({"params": _port(_np_tree(4, False))})
    b.add_param_group({"params": _port(_np_tree(4, False))})
    _, g = _grads(3, 0)
    _, g1 = _grads(4, 0, False)
    a.step([g, g1])
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    b.params = b.param_groups[0]["params"] = _tree.map_leaves(
        torch.clone, a.params)
    b._extra_groups[0]["params"] = _tree.map_leaves(
        torch.clone, a._extra_groups[0]["params"])
    _, g = _grads(3, 1)
    _, g1 = _grads(4, 1, False)
    pa, pb = a.step([g, g1]), b.step([g, g1])
    for x, y in zip(_tree.leaves(pa[0]) + _tree.leaves(pa[1]),
                    _tree.leaves(pb[0]) + _tree.leaves(pb[1])):
        assert torch.equal(x, y)


def test_jax_state_dict_carries_into_the_port():
    """A JAX FusedAdam's state_dict, pulled to numpy, loads through
    opt_state_from_numpy; one more step then matches in both."""
    tree = _np_tree(5)
    jopt = JaxFusedAdam(_jax(tree), lr=1e-2, flat=True)
    for step in range(2):
        jopt.step(_grads(5, step)[0])
    popt = FusedAdam(_port(tree), lr=1e-2, flat=True)
    sd = jax.tree_util.tree_map(np.asarray, jopt.state_dict())
    popt.load_state_dict({"state": opt_state_from_numpy(sd["state"],
                                                        device="cpu"),
                          "defaults": sd["defaults"]})
    popt.params = _port(jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jopt.params))
    popt.params["h_bf16"] = popt.params["h_bf16"].to(torch.bfloat16)
    jg, pg = _grads(5, 2)
    _assert_close(popt.step(pg), jopt.step(jg), "carried step")
    _assert_state_close(popt.state, jopt.state, "carried")


def test_error_paths():
    tree = _np_tree(6, bf16=False)
    opt = FusedAdam(_port(tree))
    with pytest.raises(ValueError, match="pass grads"):
        opt.step()
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(_port(tree), amsgrad=True)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(_port(tree), amsgrad=True)
    with pytest.raises(ValueError, match="'params' key"):
        opt.add_param_group({"lr": 1e-2})
    with pytest.raises(ValueError, match="unknown hyperparameters"):
        opt.add_param_group({"params": _port(tree), "momentum": 0.9})
    bare = FusedOptimizer(_port(tree), fused_adam(), {"lr": 1e-3})
    with pytest.raises(ValueError, match="per-group overrides"):
        bare.add_param_group({"params": _port(tree), "lr": 1e-2})
    bare.param_groups[0]["lr"] = 1e-2
    with pytest.raises(ValueError, match="no tx_factory"):
        bare.step(_grads(6, 0, False)[1])
    opt.add_param_group({"params": _port(tree)})
    g = _grads(6, 0, False)[1]
    with pytest.raises(ValueError, match="pass a list of grad trees"):
        opt.step(g)
    with pytest.raises(ValueError, match="expected 2 grad trees"):
        opt.step([g])
    with pytest.raises(ValueError, match="extra param groups"):
        FusedAdam(_port(tree)).load_state_dict(opt.state_dict())
    flat = FusedAdam(_port(tree), flat=True)
    with pytest.raises(ValueError, match="does not match"):
        flat.load_state_dict(FusedAdam(_port(tree)).state_dict())
    # a flat state's slabs do not mirror the params: they replicate
    specs = port_opt.opt_partition_specs(flat.tx, flat.params, None)
    assert specs.count == () and all(
        v == () for v in list(specs.mu.values()) + list(specs.nu.values()))
    # every optimizer of the reference is ported (fused_sgd in
    # tests/test_torch_fused_sgd.py, the rest in
    # tests/test_torch_optimizers_rest.py): each refuses AMSGrad as the
    # reference's classes do
    for name in ("FusedNovoGrad", "FusedMixedPrecisionLamb"):
        with pytest.raises(RuntimeError, match="AMSGrad"):
            getattr(port_opt, name)(_port(tree), amsgrad=True)
    for name in ("fused_novograd", "fused_adagrad",
                 "fused_mixed_precision_lamb"):
        state = getattr(port_opt, name)().init(_port(tree))
        assert _tree.leaves(state)


def test_rebuild_that_changes_the_state_layout_raises():
    """A tx_factory whose override toggles the state's layout (here tree
    -> flat moments) must refuse to carry the state over."""
    tree = _port(_np_tree(7, bf16=False))
    opt = FusedOptimizer(tree, fused_adam(lr=1e-3), {"lr": 1e-3},
                         tx_factory=lambda lr: fused_adam(lr=lr,
                                                          flat=lr > 0.5))
    opt.param_groups[0]["lr"] = 1.0
    with pytest.raises(ValueError, match="altered the optimizer state"):
        opt.step(_grads(7, 0, False)[1])


def test_zero_grad_is_a_no_op_and_closure_returns_its_loss():
    tree = _port(_np_tree(8, bf16=False))
    opt = FusedAdam(tree, lr=1e-2)
    before = _tree.map_leaves(torch.clone, tree)
    assert opt.zero_grad() is None
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(tree),
                                                 _tree.leaves(before)))
    out = opt.step(_grads(8, 0, False)[1], closure=lambda: "loss")
    assert out == "loss" and int(opt.state.count) == 1
