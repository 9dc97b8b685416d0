"""Parity of the port's last optimizers with the JAX package's over 3
steps from the same numpy params and gradients: FusedNovoGrad (Linf and
L2 norms, ``init_zero`` on and off, ``reg_inside_moment``,
``grad_averaging``), FusedAdagrad (L2 and decoupled decay),
FusedMixedPrecisionLamb (fp32 and bf16 params: the masters, the state
and the bf16 tree) and LARC (the transform and the class: no double
weight decay, a schedule at its own count, zero norms, an lr poke).

Both sides compute in fp32 and differ in summation order (the norms) and
in where XLA fuses a multiply-add: the state agrees within 1e-6 of each
leaf's largest value, fp32 params likewise, bf16 params within one bf16
ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxMPLamb
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.optimizers import fused_adagrad as jax_fused_adagrad
from apex_tpu.optimizers import (
    fused_mixed_precision_lamb as jax_fused_mp_lamb,
)
from apex_tpu.optimizers import fused_novograd as jax_fused_novograd
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu.parallel.larc import LARC as JaxLARC
from apex_tpu.parallel.larc import larc as jax_larc
from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
    fused_adagrad,
    fused_mixed_precision_lamb,
    fused_novograd,
    fused_sgd,
    opt_state_from_numpy,
)
from apex_tpu_torch.parallel import LARC, larc

REL = 1e-6  # of a leaf's largest value
BF16_RTOL = 2 ** -7  # one bf16 ulp
STEPS = 3


def _tree_np(seed, scale=1.0, zero_leaf=False):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    tree = {"w": arr(6, 5), "b": {"bias": arr(5), "k": arr(3, 2, 4)},
            "z": arr(4, 4)}
    if zero_leaf:
        tree["z"] = np.zeros((4, 4), np.float32)
    return tree


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _port(tree, dtype=torch.float32):
    return _tree.map_leaves(lambda a: torch.from_numpy(a.copy()).to(dtype),
                            tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port_tree, jax_tree, what, bf16=False):
    got = _tree.leaves(port_tree)
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, f"{what}[{i}] shape"
        if bf16:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-30,
                                       err_msg=f"{what}[{i}]")
        else:
            err = float(np.max(np.abs(g - w))) if g.size else 0.0
            scale = float(np.max(np.abs(w))) if w.size else 0.0
            assert err <= REL * scale + 1e-30, (
                f"{what}[{i}]: max err {err} > {REL} x {scale}")


def _run_both(jtx, tx, params, dtype=np.float32, zero_grad=False, steps=STEPS):
    """``steps`` updates of both transforms from the same params and
    grads; returns both states and both param trees."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp, p = _jax(params, jdt), _port(params, tdt)
    jstate, state = jtx.init(jp), tx.init(p)
    for step in range(steps):
        grads = _tree_np(100 + step, 2.0)
        if zero_grad:
            grads["b"]["bias"] = np.zeros_like(grads["b"]["bias"])
        jupd, jstate = jtx.update(_jax(grads), jstate, jp)
        upd, state = tx.update(_port(grads), state, p)
        jp = jax.tree_util.tree_map(
            lambda a, u: jnp.asarray(a + u).astype(a.dtype), jp, jupd)
        with torch.no_grad():
            for leaf, u in zip(_tree.leaves(p), _tree.leaves(upd)):
                leaf.add_(u)
    return jstate, state, jp, p


NOVO_CASES = {
    "l2": dict(norm_type=2),
    "linf": dict(norm_type=0),
    "l2_init_zero": dict(norm_type=2, init_zero=True),
    "linf_init_zero": dict(norm_type=0, init_zero=True),
    "reg_inside_moment": dict(weight_decay=0.01, reg_inside_moment=True),
    "decay_outside": dict(weight_decay=0.01),
    "no_grad_averaging": dict(grad_averaging=False, weight_decay=0.01),
    "no_bias_correction": dict(bias_correction=False, norm_type=0),
}


@pytest.mark.parametrize("case", sorted(NOVO_CASES))
def test_novograd_three_steps_match_jax(case):
    kw = NOVO_CASES[case]
    jstate, state, jp, p = _run_both(
        jax_fused_novograd(lr=1e-2, **kw), fused_novograd(lr=1e-2, **kw),
        _tree_np(0))
    assert int(state.count) == int(jstate.count) == STEPS
    _close(state.mu, jstate.mu, "mu")
    _close(state.v_norm, jstate.v_norm, "v_norm")
    assert all(v.shape == () for v in _tree.leaves(state.v_norm))
    _close(p, jp, "params")


def test_novograd_first_step_seeds_the_norm():
    """``init_zero=False``: after one step v is the first gradient's
    norm (the blend of the norm with itself); ``init_zero=True`` blends
    it with 0."""
    params = _port(_tree_np(1))
    grads = _port(_tree_np(2, 2.0))
    for init_zero in (False, True):
        tx = fused_novograd(init_zero=init_zero)
        _, state = tx.update(grads, tx.init(params), params)
        for g, v in zip(_tree.leaves(grads), _tree.leaves(state.v_norm)):
            norm = torch.linalg.vector_norm(g)
            want = norm if not init_zero else norm * (1 - 0.98) ** 0.5
            torch.testing.assert_close(v, want, rtol=1e-6, atol=0)
    with pytest.raises(RuntimeError, match="l2/inf"):
        fused_novograd(norm_type=1)


def test_novograd_schedule_sees_the_count_before_the_step():
    seen = []

    def lr(count):
        seen.append(int(count))
        return 1e-2

    tx = fused_novograd(lr=lr)
    params = _port(_tree_np(3))
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.update(params, state, params)
    assert seen == [0, 1]


@pytest.mark.parametrize("w_mode", [False, True], ids=["l2", "decoupled"])
@pytest.mark.parametrize("decay", [0.0, 0.05], ids=["nodecay", "decay"])
def test_adagrad_three_steps_match_jax(w_mode, decay):
    kw = dict(lr=5e-2, weight_decay=decay, adagrad_w_mode=w_mode)
    jstate, state, jp, p = _run_both(jax_fused_adagrad(**kw),
                                     fused_adagrad(**kw), _tree_np(4))
    assert int(state.count) == int(jstate.count) == STEPS
    _close(state.sum, jstate.sum, "sum")
    _close(p, jp, "params")


def test_adagrad_decay_order():
    """L2 mode puts the decay into the accumulator, the decoupled mode
    does not."""
    params = _port(_tree_np(5))
    grads = _port(_tree_np(6))
    sums = {}
    for w_mode in (False, True):
        tx = fused_adagrad(weight_decay=0.1, adagrad_w_mode=w_mode)
        _, state = tx.update(grads, tx.init(params), params)
        sums[w_mode] = state.sum
    for g, p, h_l2, h_w in zip(*map(_tree.leaves, (grads, params, sums[False],
                                                  sums[True]))):
        torch.testing.assert_close(h_w, g * g)
        torch.testing.assert_close(h_l2, (g + 0.1 * p) ** 2)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["fp32", "bf16"])
def test_mixed_precision_lamb_three_steps_match_jax(dtype):
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0)
    jstate, state, jp, p = _run_both(jax_fused_mp_lamb(**kw),
                                     fused_mixed_precision_lamb(**kw),
                                     _tree_np(7), dtype=dtype)
    _close(state.master, jstate.master, "master")
    assert all(m.dtype == torch.float32 for m in _tree.leaves(state.master))
    _close(state.inner.mu, jstate.inner.mu, "mu")
    _close(state.inner.nu, jstate.inner.nu, "nu")
    assert int(state.inner.count) == int(jstate.inner.count) == STEPS
    _close(p, jp, "params", bf16=dtype == "bf16")
    if dtype == "bf16":
        assert all(x.dtype == torch.bfloat16 for x in _tree.leaves(p))


def test_mixed_precision_lamb_applies_the_references_difference():
    """The model's update is ``round(master) - p`` in bf16, applied as
    ``p + (round(master) - p)``: equal to the reference's bf16 tree bit
    for bit, and where that sum rounds away from ``round(master)`` the
    port keeps the reference's value."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal(4096).astype(np.float32)
    params = {"w": w}
    grads = {"w": rng.standard_normal(4096).astype(np.float32)}
    kw = dict(lr=5e-2, weight_decay=0.0, max_grad_norm=0.0)
    jtx, tx = jax_fused_mp_lamb(**kw), fused_mixed_precision_lamb(**kw)
    jp, p = _jax(params, jnp.bfloat16), _port(params, torch.bfloat16)
    jupd, jstate = jtx.update(_jax(grads), jtx.init(jp), jp)
    upd, state = tx.update(_port(grads), tx.init(p), p)
    jnew = np.asarray(jnp.asarray(jp["w"] + jupd["w"]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    with torch.no_grad():
        p["w"].add_(upd["w"])
    np.testing.assert_array_equal(p["w"].float().numpy(), jnew)
    rounded = state.master["w"].to(torch.bfloat16)
    differ = int((p["w"] != rounded).sum())
    assert differ == int((jnew != np.asarray(
        jnp.asarray(jstate.master["w"]).astype(jnp.bfloat16).astype(
            jnp.float32))).sum())


def _sched(count):
    return 0.1 * 0.5 ** count


LARC_CASES = {
    "clip": dict(lr=0.1, clip=True),
    "noclip": dict(lr=0.1, clip=False),
    "decay": dict(lr=0.1, clip=True, weight_decay=1e-3),
    "schedule": dict(lr=_sched, clip=True),
}


@pytest.mark.parametrize("case", sorted(LARC_CASES))
def test_larc_transform_three_steps_match_jax(case):
    kw = LARC_CASES[case]
    jinner = jax_fused_sgd(lr=kw["lr"], momentum=0.9)
    inner = fused_sgd(lr=kw["lr"], momentum=0.9)
    jstate, state, jp, p = _run_both(
        jax_larc(jinner, trust_coefficient=0.02, **kw),
        larc(inner, trust_coefficient=0.02, **kw),
        _tree_np(9, zero_leaf=True), zero_grad=True)
    assert int(state.count) == int(jstate.count) == STEPS
    _close(state.inner.momentum_buffer, jstate.inner.momentum_buffer, "buf")
    _close(p, jp, "params")


def test_larc_zero_norms_pass_through_unscaled():
    params = _port(_tree_np(10, zero_leaf=True))
    grads = _port(_tree_np(11))
    grads["b"]["bias"].zero_()
    seen = {}

    class Inner:
        def init(self, params):
            return None

        def update(self, g, state, params):
            seen["g"] = g
            return _tree.map_leaves(torch.zeros_like, g), state

    tx = larc(Inner(), lr=0.1)
    tx.update(grads, tx.init(params), params)
    torch.testing.assert_close(seen["g"]["z"], grads["z"])  # ||p|| = 0
    torch.testing.assert_close(seen["g"]["b"]["bias"], grads["b"]["bias"])
    assert not torch.equal(seen["g"]["w"], grads["w"])


def test_larc_class_matches_jax_with_an_lr_poke():
    """LARC over FusedSGD with weight decay: the inner optimizer runs
    with weight_decay 0 (LARC adds it once), and an lr poke between steps
    rebuilds both transforms, as in the reference."""
    params = _tree_np(12, zero_leaf=True)
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-3)
    jopt = JaxLARC(JaxFusedSGD(_jax(params), **kw))
    opt = LARC(FusedSGD(_port(params), **kw))
    assert opt._inner_tx is not opt.optim.tx
    for step in range(STEPS):
        if step == 2:
            jopt.param_groups[0]["lr"] = 0.05
            opt.param_groups[0]["lr"] = 0.05
        grads = _tree_np(200 + step, 2.0)
        jopt.step(_jax(grads))
        opt.step(_port(grads))
        _close(opt.params, jopt.params, f"step {step} params")
    assert opt._built_lr == 0.05
    _close(opt.state.inner.momentum_buffer,
           jopt.state.inner.momentum_buffer, "buf")
    assert opt.optim.state is opt.state.inner
    # no double decay: the inner step alone adds none
    p0 = _port(params)
    plain = FusedSGD(_tree.map_leaves(torch.clone, p0), lr=0.1, momentum=0.9)
    wrapped = LARC(FusedSGD(_tree.map_leaves(torch.clone, p0), lr=0.1,
                            momentum=0.9, weight_decay=1e-3))
    g = _port(_tree_np(13))
    wrapped.step(g)
    scaled = larc(plain.tx, lr=0.1, weight_decay=1e-3)
    s = scaled.init(plain.params)
    upd, _ = scaled.update(g, s, plain.params)
    for got, p, u in zip(_tree.leaves(wrapped.params),
                         _tree.leaves(plain.params), _tree.leaves(upd)):
        torch.testing.assert_close(got, p + u, rtol=0, atol=0)


@pytest.mark.parametrize("cls,jcls,kw", [
    (FusedAdagrad, JaxFusedAdagrad, dict(lr=1e-2, weight_decay=0.01)),
    (FusedNovoGrad, JaxFusedNovoGrad, dict(lr=1e-2, weight_decay=0.01,
                                           norm_type=0)),
    (FusedMixedPrecisionLamb, JaxMPLamb, dict(lr=1e-2)),
], ids=["adagrad", "novograd", "mp_lamb"])
def test_stateful_classes_match_jax_and_carry_their_state(cls, jcls, kw):
    """Three class steps match; the JAX state after them, pulled to
    numpy, loads through ``opt_state_from_numpy`` and a fourth step
    matches again."""
    params = _tree_np(14)
    jopt, opt = jcls(_jax(params), **kw), cls(_port(params), **kw)
    for step in range(STEPS):
        grads = _tree_np(300 + step, 2.0)
        jopt.step(_jax(grads))
        opt.step(_port(grads))
    _close(opt.params, jopt.params, "params")
    sd = jax.tree_util.tree_map(np.asarray, jopt.state_dict())
    fresh = cls(_tree.map_leaves(torch.clone, opt.params), **kw)
    fresh.load_state_dict({"state": opt_state_from_numpy(
        sd["state"], device="cpu")})
    assert type(fresh.state).__name__ == type(jopt.state).__name__
    grads = _tree_np(400, 2.0)
    jopt.step(_jax(grads))
    fresh.step(_port(grads))
    _close(fresh.params, jopt.params, "params after the carried step")


def test_larc_state_converts():
    jtx = jax_larc(jax_fused_sgd(lr=0.1, momentum=0.9), lr=0.1)
    params = _jax(_tree_np(15))
    _, jstate = jtx.update(_jax(_tree_np(16)), jtx.init(params), params)
    state = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    assert type(state).__name__ == "LARCState"
    assert type(state.inner).__name__ == "FusedSGDState"
    assert state.count.dtype == torch.int32 and int(state.count) == 1
    _close(state.inner.momentum_buffer, jstate.inner.momentum_buffer, "buf")
    with pytest.raises(TypeError, match="no port of optimizer state"):
        opt_state_from_numpy(type("Other", (tuple,), {"_fields": ()})(),
                             device="cpu")
