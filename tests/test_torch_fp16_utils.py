"""Parity of the port's pre-amp fp16 workflow (apex_tpu_torch.fp16_utils,
contrib.clip_grad, contrib.optimizers) with the JAX package's: every
fp16util helper (the batchnorm exemption, flat and tree masters, the
clip), the loss scalers' scale sequence over planted overflows step by
step, and FP16_Optimizer's steps, skip, clip and state_dict round trip,
from the same numpy params and gradients. Casts are bit for bit; fp32
results within 1e-6 of a leaf's largest value (summation order), bf16
model params within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as jfp
from apex_tpu.contrib.clip_grad import clip_grad_norm_ as jax_clip_
from apex_tpu.contrib.optimizers import FP16_Optimizer as JaxContribFP16
from apex_tpu.contrib.optimizers.fused_adam import FusedAdam as JaxContribAdam
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch import _tree
from apex_tpu_torch import fp16_utils as pfp
from apex_tpu_torch.contrib import optimizers as contrib_opt
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm, clip_grad_norm_
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

REL = 1e-6
BF16_RTOL = 2 ** -7


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"conv": {"kernel": arr(3, 4)}, "bn1": {"scale": arr(4),
                                                   "bias": arr(4)},
            "block": {"BatchNorm_0": {"scale": arr(5)},
                      "dense": {"kernel": arr(5, 2)}},
            "batch_stats": {"mean": arr(4)}, "head": arr(2, 3)}


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _port(tree, dtype=torch.float32):
    return _tree.map_leaves(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                            tree)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dtype_name(x):
    return str(x.dtype).rsplit(".", 1)[-1]


def _same(port_tree, jax_tree, exact=True, rel=REL, what=""):
    got, _ = _tree.flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert _dtype_name(g) == str(jnp.asarray(w).dtype), path
        g, w = _as_np(g), _as_np(w)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}{path}")
        else:
            err = float(np.max(np.abs(g - w))) if g.size else 0.0
            assert err <= rel * float(np.max(np.abs(w))) + 1e-30, (
                f"{what}{path}: {err}")


def test_casts_and_the_batchnorm_exemption_match_jax():
    tree = _np_tree(0)
    jt, pt = _jax(tree), _port(tree)
    _same(pfp.tofp16(pt), jfp.tofp16(jt))
    _same(pfp.tofp16(pt, torch.float16), jfp.tofp16(jt, jnp.float16))
    _same(pfp.BN_convert_float(pfp.tofp16(pt)),
          jfp.BN_convert_float(jfp.tofp16(jt)))
    _same(pfp.network_to_half(pt), jfp.network_to_half(jt))
    _same(pfp.convert_module(pt, torch.float16),
          jfp.convert_module(jt, jnp.float16))
    _same(pfp.convert_network(pt, torch.float16),
          jfp.convert_network(jt, jnp.float16))
    half = pfp.network_to_half(pt)
    assert half["bn1"]["scale"].dtype == torch.float32
    assert half["block"]["BatchNorm_0"]["scale"].dtype == torch.float32
    assert half["batch_stats"]["mean"].dtype == torch.float32
    assert half["conv"]["kernel"].dtype == torch.bfloat16
    # a caller's own predicate on the keystr path
    only_head = pfp.BN_convert_float(pfp.tofp16(pt),
                                     is_batchnorm=lambda s: "head" in s)
    _same(only_head, jfp.BN_convert_float(
        jfp.tofp16(jt), is_batchnorm=lambda s: "head" in s))
    # non-float leaves pass through
    mixed = {"w": torch.ones(2), "step": torch.tensor(3, dtype=torch.int32)}
    assert pfp.tofp16(mixed)["step"].dtype == torch.int32


def test_fp16_model_casts_inputs_and_params():
    tree = _np_tree(1)
    x = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)

    def japply(p, x):
        return x @ p["conv"]["kernel"] * p["bn1"]["scale"]

    def papply(p, x):
        return x @ p["conv"]["kernel"] * p["bn1"]["scale"]

    jm = jfp.FP16Model(japply, _jax(tree))
    pm = pfp.FP16Model(papply, _port(tree))
    _same(pm.params, jm.params)
    out = pm(torch.from_numpy(x), )
    jout = jm(jnp.asarray(x))
    np.testing.assert_allclose(_as_np(out), _as_np(jout), rtol=BF16_RTOL)


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_master_lists_match_jax(flat):
    tree = _np_tree(3)
    jhalf, phalf = jfp.tofp16(_jax(tree)), pfp.tofp16(_port(tree))
    jmodel, jmaster = jfp.prep_param_lists(jhalf, flat_master=flat)
    pmodel, pmaster = pfp.prep_param_lists(phalf, flat_master=flat)
    assert pmodel is phalf
    if flat:
        np.testing.assert_array_equal(_as_np(pmaster), _as_np(jmaster))
        assert pmaster.dtype == torch.float32 and pmaster.dim() == 1
    else:
        _same(pmaster, jmaster)
    grads = _np_tree(4)
    jg = jfp.model_grads_to_master_grads(jfp.tofp16(_jax(grads)),
                                         flat_master=flat)
    pg = pfp.model_grads_to_master_grads(pfp.tofp16(_port(grads)),
                                         flat_master=flat)
    if flat:
        np.testing.assert_array_equal(_as_np(pg), _as_np(jg))
    else:
        _same(pg, jg)
    # the masters move; the model takes them rounded
    jmaster = jax.tree_util.tree_map(lambda m: m * 1.001, jmaster)
    pmaster = (pmaster * 1.001 if flat
               else _tree.map_leaves(lambda m: m * 1.001, pmaster))
    _same(pfp.master_params_to_model_params(pmodel, pmaster, flat),
          jfp.master_params_to_model_params(jmodel, jmaster, flat))


def test_masters_never_alias_fp32_params():
    p = {"w": torch.ones(3)}
    _, master = pfp.prep_param_lists(p)
    master["w"].add_(1.0)
    assert float(p["w"][0]) == 1.0


def test_flat_master_packs_float_leaves_only():
    p = {"a": torch.ones(2, dtype=torch.bfloat16),
         "n": torch.arange(3, dtype=torch.int32),
         "z": torch.full((3,), 2.0, dtype=torch.bfloat16)}
    _, master = pfp.prep_param_lists(p, flat_master=True)
    assert master.tolist() == [1.0, 1.0, 2.0, 2.0, 2.0]
    back = pfp.master_params_to_model_params(p, master * 2, flat_master=True)
    assert back["n"] is p["n"] and back["z"].tolist() == [4.0] * 3


def test_to_python_float():
    assert pfp.to_python_float(torch.tensor([2.5])) == 2.5
    assert pfp.to_python_float(torch.tensor(1.5)) == 1.5
    assert pfp.to_python_float(3) == 3.0
    assert pfp.to_python_float(torch.tensor(0.1)) == jfp.to_python_float(
        jnp.asarray(0.1))


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")],
                         ids=["l2", "l1", "inf"])
@pytest.mark.parametrize("max_norm", [1.0, 1e4], ids=["clipped", "under"])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    grads = _np_tree(5, 3.0)
    jc, jn = jfp.clip_grad_norm(_jax(grads), max_norm, norm_type)
    pc, pn = pfp.clip_grad_norm(_port(grads), max_norm, norm_type)
    np.testing.assert_allclose(float(pn), float(jn), rtol=REL)
    _same(pc, jc, exact=False)
    jc2, jn2 = jax_clip_(_jax(grads), max_norm, norm_type)
    pc2, pn2 = clip_grad_norm_(_port(grads), max_norm, norm_type)
    np.testing.assert_allclose(float(pn2), float(jn2), rtol=REL)
    _same(pc2, jc2, exact=False)
    assert clip_grad_norm is clip_grad_norm_


def test_clip_error_if_nonfinite():
    grads = _port(_np_tree(6))
    grads["head"][0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        clip_grad_norm_(grads, 1.0, error_if_nonfinite=True)
    _, norm = clip_grad_norm_(grads, 1.0)
    assert not torch.isfinite(norm)


def test_loss_scalers_match_jax_step_by_step():
    """The scale sequence over planted overflows (with a window of 3 and
    a floor reached), and each overflow verdict, equal the reference's."""
    kw = dict(init_scale=8.0, scale_factor=2.0, scale_window=3)
    js, ps = jfp.DynamicLossScaler(**kw), pfp.DynamicLossScaler(**kw)
    assert pfp.DynamicLossScaler().cur_scale == 2.0 ** 32
    plan = [False, True, False, False, False, False, True, True, True, True,
            True, False, False, False]
    for i, overflow in enumerate(plan):
        g = _np_tree(10 + i)
        if overflow:
            g["head"][1, 2] = np.inf if i % 2 else np.nan
        jflag, pflag = js.has_overflow(_jax(g)), ps.has_overflow(_port(g))
        assert jflag == pflag == overflow
        js.update_scale(jflag)
        ps.update_scale(pflag)
        assert (ps.cur_scale, ps.cur_iter, ps.last_overflow_iter) == (
            js.cur_scale, js.cur_iter, js.last_overflow_iter), i
    assert ps.cur_scale >= 1.0
    static = pfp.LossScaler(4.0)
    assert static.has_overflow(None) is False and static.loss_scale == 4.0
    assert float(static.backward(torch.tensor(2.0))) == 8.0
    half = static.scale_gradient({"a": torch.full((2,), 8.0)})
    assert half["a"].tolist() == [2.0, 2.0]


def _fp16_pair(params, flat, dynamic, jcls=None, pcls=None, **kw):
    jcls = jcls or jfp.FP16_Optimizer
    pcls = pcls or pfp.FP16_Optimizer
    jopt = jcls(JaxFusedAdam(jfp.tofp16(_jax(params)), lr=1e-2, flat=flat),
                dynamic_loss_scale=dynamic, **kw)
    popt = pcls(FusedAdam(pfp.tofp16(_port(params)), lr=1e-2, flat=flat),
                dynamic_loss_scale=dynamic, **kw)
    return jopt, popt


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_fp16_optimizer_steps_skip_and_clip_match_jax(flat):
    """4 steps under a dynamic scale (init 2^10, window 2) with an inf at
    step 2: the skip leaves masters, Adam state and the model tree as
    they were and halves the scale; every step's clip norm, scale and
    model tree equal the reference's."""
    params = _np_tree(20)
    args = {"init_scale": 2.0 ** 10, "scale_window": 2}
    jopt, popt = _fp16_pair(params, flat, True, dynamic_loss_args=args)
    for step in range(4):
        g = _np_tree(30 + step, 0.5)
        scale = popt.loss_scale
        assert scale == jopt.loss_scale
        jg = jfp.tofp16(_jax(jax.tree_util.tree_map(lambda a: a * scale, g)))
        pg = pfp.tofp16(_port(_tree.map_leaves(lambda a: a * scale, g)))
        if step == 2:
            jg["head"] = jg["head"].at[0, 0].set(jnp.inf)
            pg["head"][0, 0] = float("inf")
        jg, jnorm = jopt.clip_master_grads(jg, 1.0)
        pg, pnorm = popt.clip_master_grads(pg, 1.0)
        if step == 2:
            assert not torch.isfinite(pnorm)
            before = (_tree.map_leaves(torch.clone, popt.optimizer.params),
                      [t.clone() for t in _tree.leaves(popt.optimizer.state)])
        else:
            np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=REL)
        jmodel = jopt.step(jg)
        pmodel = popt.step(pg)
        assert popt.overflow == jopt.overflow == (step == 2)
        assert popt.loss_scale == jopt.loss_scale
        _same(pmodel, jmodel, exact=False, rel=BF16_RTOL)
        for m, p in zip(_tree.leaves(popt.optimizer.params),
                        _tree.leaves(pmodel)):
            assert torch.equal(m.to(p.dtype), p)
        if step == 2:
            for a, b in zip(_tree.leaves(before[0]),
                            _tree.leaves(popt.optimizer.params)):
                assert torch.equal(a, b)
            for a, b in zip(before[1], _tree.leaves(popt.optimizer.state)):
                assert torch.equal(a, b)
    _same(popt.optimizer.params, jopt.optimizer.params, exact=False)
    _same(popt.optimizer.state.mu, jopt.optimizer.state.mu, exact=False)


def test_fp16_optimizer_state_dict_round_trip_and_reads_the_references():
    params = _np_tree(40)
    jopt, popt = _fp16_pair(params, True, True)
    for step in range(2):
        g = _np_tree(50 + step)
        jopt.step(jfp.tofp16(_jax(g)))
        popt.step(pfp.tofp16(_port(g)))
    sd = popt.state_dict()
    assert set(sd) == {"optimizer_state", "cur_scale", "overflow"}
    other = pfp.FP16_Optimizer(FusedAdam(pfp.tofp16(_port(params)), lr=1e-2,
                                         flat=True), dynamic_loss_scale=True)
    other.load_state_dict(sd)
    assert other.loss_scale == popt.loss_scale
    assert int(other.optimizer.state.count) == 2
    # the reference's state dict, pulled to numpy, loads too
    jsd = jax.tree_util.tree_map(np.asarray, jopt.state_dict())
    third = pfp.FP16_Optimizer(FusedAdam(pfp.tofp16(_port(params)), lr=1e-2,
                                         flat=True), dynamic_loss_scale=True)
    third.load_state_dict(jsd)
    assert third.loss_scale == jopt.loss_scale
    assert third.overflow == bool(jsd["overflow"])
    _same(third.optimizer.state.mu, jopt.optimizer.state.mu)
    _same(third.optimizer.state.nu, jopt.optimizer.state.nu)


def test_fp16_optimizer_over_lamb_with_a_static_scale():
    params = _np_tree(60)
    jopt = jfp.FP16_Optimizer(JaxFusedLAMB(jfp.tofp16(_jax(params)),
                                           lr=1e-2), static_loss_scale=128.0)
    popt = pfp.FP16_Optimizer(FusedLAMB(pfp.tofp16(_port(params)), lr=1e-2),
                              static_loss_scale=128.0)
    for step in range(3):
        g = _np_tree(70 + step, 128.0)
        jm = jopt.step(jfp.tofp16(_jax(g)))
        pm = popt.step(pfp.tofp16(_port(g)))
        _same(pm, jm, exact=False, rel=BF16_RTOL)
    assert popt.loss_scale == 128.0 and not popt.overflow
    assert float(popt.scale_loss(torch.tensor(1.0))) == 128.0
    assert float(popt.backward(torch.tensor(2.0))) == 256.0
    assert popt.inspect_master_grad_data() is None
    assert popt.zero_grad() is None and popt.update_master_grads() is None
    with pytest.raises(ValueError, match="pass grads"):
        popt.step()


def test_contrib_optimizers():
    params = _np_tree(80)
    jopt, popt = _fp16_pair(params, False, True, jcls=JaxContribFP16,
                            pcls=contrib_opt.FP16_Optimizer)
    assert isinstance(popt.loss_scaler, pfp.DynamicLossScaler)
    assert isinstance(contrib_opt.FP16_Optimizer(
        FusedAdam(pfp.tofp16(_port(params)))).loss_scaler,
        pfp.DynamicLossScaler)
    # the contrib FusedAdam is L2 mode, its legacy knobs ignored
    jadam = JaxContribAdam(_jax(params), lr=1e-2, weight_decay=0.1,
                           max_grad_norm=5.0, use_mt=True)
    padam = contrib_opt.FusedAdam(_port(params), lr=1e-2, weight_decay=0.1,
                                  max_grad_norm=5.0, use_mt=True)
    for step in range(3):
        g = _np_tree(90 + step)
        jparams = jadam.step(_jax(g))
        padam.step(_port(g))
    _same(padam.params, jparams, exact=False)
    assert contrib_opt.FusedLAMB is FusedLAMB
    # the distributed optimizers are ported (tests/test_torch_contrib_
    # dist.py holds them against the reference on 2 ranks): their classes
    # hold a transform and init nothing before a process group exists
    for name in ("DistributedFusedAdam", "DistributedFusedLAMB"):
        opt = getattr(contrib_opt, name)(_port(params), lr=1e-2)
        assert opt.state is None and callable(opt.tx.update)
    for name in ("distributed_fused_adam", "distributed_fused_lamb"):
        tx = getattr(contrib_opt, name)(lr=1e-2)
        assert callable(tx.init) and callable(tx.step)
