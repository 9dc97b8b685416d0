"""Parity of the port's amp (apex_tpu_torch.amp: opt levels, the loss
scaler, the functional and stateful amp steps) with the JAX package's
apex_tpu.amp, on the CPU.

Tolerances: the loss-scaler automaton is integer and power-of-two
arithmetic on both sides and must match field by field exactly; the
unscale ``(g.float() * (1 / scale)).to(g.dtype)`` is one fp32 product
and one rounding on both sides and must match bit for bit. Optimizer
updates after it are the fp32 Adam of test_torch_optimizers_stateful.py
(RTOL/ATOL, a few ulps). The O2 Llama tiny() slice (fp32 activations,
bf16 weights, fp32 norms and masters; JAX's Pallas kernels in interpret
mode) holds losses to LOSS_RTOL and each param's displacement to
STEP_RTOL in relative L2, as test_torch_training.py does and for the
same reason: bf16 grads of two fp32 sums taken in another order may
round one ulp apart, and Adam moves a noise-level element by up to lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import llama as jax_llama
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _tree, amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.optimizers import FusedAdam, fused_adam

RTOL, ATOL = 1e-5, 2e-7
LOSS_RTOL, STEP_RTOL = 1e-5, 2e-3
LR = 1e-3

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.float16: torch.float16, None: None}


@pytest.fixture(autouse=True)
def _fresh_amp_state():
    """Both packages keep the active handle process-wide."""
    yield
    _amp_state._amp_state.handle = None
    from apex_tpu.amp import _amp_state as jstate

    jstate._amp_state.handle = None


def _dtype(d):
    return DTYPES[None if d is None else jnp.dtype(d).type]


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4"])
def test_properties_match_jax_field_by_field(level):
    want = jamp.frontend._opt_level_props(level, jnp.bfloat16)
    got = amp.frontend._opt_level_props(level, torch.bfloat16)
    assert got.enabled == want.enabled and got.opt_level == want.opt_level
    assert got.cast_model_type == _dtype(want.cast_model_type)
    assert got.patch_torch_functions == want.patch_jax_functions
    assert got.keep_batchnorm_fp32 == want.keep_batchnorm_fp32
    assert got.master_weights == want.master_weights
    assert got.loss_scale == want.loss_scale and got.fp8 == want.fp8
    jh, ph = jamp.AmpHandle(want), amp.AmpHandle(got)
    assert ph.policy.param_dtype == _dtype(jh.policy.param_dtype)
    assert ph.policy.compute_dtype == _dtype(jh.policy.compute_dtype)
    assert ph.policy.keep_batchnorm_fp32 == jh.policy.keep_batchnorm_fp32
    assert ph.scaler.enabled == jh.scaler.enabled
    assert ph.scaler.dynamic == jh.scaler.dynamic
    assert float(ph.scaler_state.loss_scale) == float(
        jh.scaler_state.loss_scale)
    with pytest.raises(ValueError, match="letter O"):
        amp.initialize(opt_level="o2")


@pytest.mark.parametrize("level", ["O2", "O3", "O4"])
def test_cast_model_over_llama_tiny_matches_jax(level):
    """Which leaves stay fp32 (the norms at O2/O4) and which go bf16,
    and that the cast is a copy, never an alias."""
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.tiny())
    params = port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jcast = jamp.initialize(opt_level=level).policy.cast_model(jparams)
    cast = amp.initialize(opt_level=level).policy.cast_model(params)
    fp32 = []
    for path, ref in jax.tree_util.tree_flatten_with_path(jcast)[0]:
        keys = [k.key for k in path]
        node, src = cast, params
        for key in keys:
            node, src = node[key], src[key]
        assert node.dtype == _dtype(ref.dtype), keys
        assert node.data_ptr() != src.data_ptr()
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
        if node.dtype == torch.float32:
            fp32.append("/".join(keys))
    want = (["final_norm", "layers/attn_norm", "layers/mlp_norm"]
            if level != "O3" else [])
    assert sorted(fp32) == want


SCALERS = {
    "dynamic": dict(scale_window=5),
    "clamped": dict(scale_window=5, min_loss_scale=2.0 ** 14,
                    max_loss_scale=2.0 ** 18),
    "backoff": dict(scale_window=5, backoff_factor=0.25,
                    min_loss_scale=1.0),
    "static": dict(loss_scale=128.0),
}


@pytest.mark.parametrize("name", sorted(SCALERS))
def test_loss_scaler_sequence_matches_jax(name):
    """40 updates over a seeded overflow pattern (runs of clean steps
    long enough to grow, bursts long enough to reach the floor): every
    field after every update, exactly, and the same `report`."""
    kw = SCALERS[name]
    jsc, psc = jamp.LossScaler(**kw), amp.LossScaler(**kw)
    js, ps = jsc.init(), psc.init()
    pattern = np.random.default_rng(7).random(40) < 0.3
    pattern[20:26] = True  # a burst of six overflows
    pattern[26:38] = False  # then enough clean steps to grow twice
    for i, ovf in enumerate(pattern):
        js = jsc.update(js, jnp.asarray(bool(ovf)))
        ps = psc.update(ps, torch.tensor(bool(ovf)))
        assert psc.state_dict(ps) == jsc.state_dict(js), f"step {i}"
        assert ps.loss_scale.dtype == torch.float32
        assert ps.unskipped.dtype == torch.int32
    assert psc.overflow_count(ps) == jsc.overflow_count(js) == int(
        pattern.sum())
    # the scaler's health readout, as the reference publishes it
    from apex_tpu import observability as jobs
    from apex_tpu_torch import observability as pobs

    assert psc.report(ps, registry=pobs.MetricRegistry()) == jsc.report(
        js, registry=jobs.MetricRegistry())


@pytest.mark.parametrize("scale", [2.0 ** 16, 3.0, 2.0 ** -3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unscale_bit_for_bit(scale, dtype):
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((6, 5)).astype(np.float32) * 1e3,
            "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    jsc = jamp.LossScaler(loss_scale=scale)
    psc = amp.LossScaler(loss_scale=scale)
    jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
    pg = _tree.map_leaves(lambda x: torch.from_numpy(x).to(
        getattr(torch, dtype)), tree)
    ju, jovf = jsc.unscale(jg, jsc.init())
    pu, povf = psc.unscale(pg, psc.init())
    assert bool(povf) == bool(jovf) is False
    for path, ref in jax.tree_util.tree_flatten_with_path(ju)[0]:
        node = pu
        for key in path:
            node = node[key.key]
        assert str(node.dtype).endswith(dtype)
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    pg["b"]["c"][3] = float("nan")
    assert bool(psc.unscale(pg, psc.init())[1])
    # a scaled loss is the loss times the scale in the loss's dtype
    loss = torch.tensor(1.5, dtype=torch.float32)
    assert float(psc.scale_loss(loss, psc.init())) == float(
        jsc.scale_loss(jnp.float32(1.5), jsc.init()))


def _adam_pair(flat):
    return (jax_fused_adam(lr=LR, weight_decay=0.01, flat=flat),
            fused_adam(lr=LR, weight_decay=0.01, flat=flat))


def _np_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "n": {"b": rng.standard_normal(5).astype(np.float32)}}


def _assert_tree(port_tree, jax_tree, what, rtol=RTOL, atol=ATOL,
                 exact=False):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(_tree.leaves(port_tree)), what
    for path, ref in flat:
        node = port_tree
        for key in path:
            node = node[key.key]
        got = node.detach().float().numpy()
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        msg = f"{what}{jax.tree_util.keystr(path)}"
        if exact:
            np.testing.assert_array_equal(got, ref, err_msg=msg)
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=msg)


@pytest.mark.parametrize("flat", [False, True])
def test_scaled_update_matches_jax_with_a_skipped_step(flat):
    """The functional amp step: 3 clean steps and an overflow step whose
    updates are zeros and whose optimizer state comes back untouched."""
    jtx, ptx = _adam_pair(flat)
    jsc = jamp.LossScaler(scale_window=2)
    psc = amp.LossScaler(scale_window=2)
    tree = _np_params(1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = _tree.map_leaves(torch.from_numpy, tree)
    js, ps = jtx.init(jp), ptx.init(pp)
    jss, pss = jsc.init(), psc.init()
    for step in range(4):
        g = _tree.map_leaves(lambda x: x * 2.0 ** 16, _np_params(100 + step))
        if step == 3:
            g["w"][1, 2] = np.inf
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        pg = _tree.map_leaves(torch.from_numpy, g)
        ju, js2, jss, jovf = jamp.scaled_update(jtx, jsc, jg, js, jp, jss)
        pu, ps2, pss, povf = amp.scaled_update(ptx, psc, pg, ps, pp, pss)
        assert bool(povf) == bool(jovf) == (step == 3)
        assert psc.state_dict(pss) == jsc.state_dict(jss)
        _assert_tree(pu, ju, f"updates {step}")
        if step == 3:
            assert ps2 is ps and all(not u.any() for u in _tree.leaves(pu))
        js, ps = js2, ps2
        jp = jax.tree_util.tree_map(jnp.add, jp, ju)
        for p, u in zip(_tree.leaves(pp), _tree.leaves(pu)):
            p.add_(u)
    assert int(ps.count) == int(js.count) == 3
    _assert_tree(ps.mu, js.mu, "mu")
    _assert_tree(pp, jp, "params")


def _o2_pair(flat, jparams, params, level="O2"):
    """The stateful O2 set-up of tests/run_amp/test_amp.py:195-206 on
    both sides: initialize, then the optimizer holds the cast tree and
    fp32 masters of it."""
    jopt = JaxFusedAdam(jparams, lr=LR, flat=flat)
    jcast, jopt, jh = jamp.initialize(jparams, jopt, opt_level=level)
    jopt.params = jcast
    jopt.master_params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jcast)
    popt = FusedAdam(params, lr=LR, flat=flat)
    cast, popt2, ph = amp.initialize(params, popt, opt_level=level)
    assert popt2 is popt and amp.state_dict() == ph.state_dict()
    popt.params = cast
    popt.master_params = _tree.map_leaves(lambda p: p.float(), cast)
    return (jopt, jh), (popt, ph)


@pytest.mark.parametrize("flat", [False, True])
def test_attach_o2_three_steps_and_a_skip(flat):
    """attach at O2: 3 steps with grads at the loss scale, then a step
    with an inf grad, skipped: masters fp32 at RTOL, bf16 params equal
    to JAX's and to master.to(bf16), the state counter and slabs
    unmoved by the skip, the scale halved."""
    tree = {"dense": {"kernel": np.random.default_rng(2).standard_normal(
        (4, 4)).astype(np.float32)},
        "layernorm": {"scale": np.ones(4, np.float32)}}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = _tree.map_leaves(lambda x: torch.from_numpy(x.copy()), tree)
    (jopt, jh), (popt, ph) = _o2_pair(flat, jparams, params)
    assert popt.params["dense"]["kernel"].dtype == torch.bfloat16
    assert popt.params["layernorm"]["scale"].dtype == torch.float32
    assert popt.master_params["dense"]["kernel"].dtype == torch.float32
    for step in range(4):
        scale = float(ph.scaler_state.loss_scale)
        g = _tree.map_leaves(lambda x: x * 0.5 * scale,
                             _np_params_like(tree, 200 + step))
        if step == 3:
            g["dense"]["kernel"][0, 0] = np.inf
            mu_before = [m.clone() for m in _tree.leaves(popt.state.mu)]
        jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                    g)
        pg = _tree.map_leaves(lambda x: torch.from_numpy(x).to(
            torch.bfloat16), g)
        jopt.step(jg)
        with ph.scale_loss(torch.tensor(1.0)) as scaled:
            assert float(scaled) == scale
        assert popt.step(pg) is popt.params
        _assert_tree(popt.master_params, jopt.master_params, f"master {step}")
        _assert_tree(popt.params, jopt.params, f"params {step}", exact=True)
        for p, m in zip(_tree.leaves(popt.params),
                        _tree.leaves(popt.master_params)):
            assert torch.equal(p, m.to(p.dtype))
        assert ph.state_dict() == jh.state_dict()
    assert int(popt.state.count) == int(jopt.state.count) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        mu_before, _tree.leaves(popt.state.mu)))
    sd = ph.state_dict()
    assert sd["loss_scale"] == 2.0 ** 15 and sd["overflows"] == 1
    assert sd["skip_streak"] == 1 and sd["last_overflow_step"] == 3
    assert list(amp.master_params(popt)) == _tree.leaves(popt.master_params)


def _np_params_like(tree, seed):
    rng = np.random.default_rng(seed)
    return _tree.map_leaves(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)


def test_module_level_state_dict_and_handles():
    h = amp.initialize(opt_level="O2")
    h.scaler_state = h.scaler.update(h.scaler_state, True)
    sd = amp.state_dict()
    assert sd["loss_scale"] == 2.0 ** 15
    h2 = amp.initialize(opt_level="O2")
    amp.load_state_dict(sd)
    assert float(h2.scaler_state.loss_scale) == 2.0 ** 15
    assert int(h2.scaler_state.overflows) == 1
    with amp.scale_loss(torch.tensor(2.0)) as scaled:
        assert float(scaled) == 2.0 ** 16
    with pytest.raises(RuntimeError, match="O4"):
        h2.init_fp8(["lm_head"], device="cpu")
    with h2.disable_casts():
        assert h2.policy.compute_dtype == torch.float32
    assert h2.policy.compute_dtype == torch.bfloat16
    assert h2.is_active and not h2.has_cache and h2.cache == {}
    noop = amp.NoOpHandle()
    with noop.scale_loss(3.0) as same:
        assert same == 3.0
    assert noop.state_dict() == {} and not noop.is_active
    _amp_state._amp_state.handle = None
    assert amp.state_dict() == {}
    with pytest.raises(RuntimeError, match="initialize"):
        amp.load_state_dict(sd)
    with pytest.raises(RuntimeError, match="initialize"):
        amp.scale_loss(torch.tensor(1.0))


def test_disabled_amp_leaves_params_and_optimizer_alone():
    params = {"w": torch.ones(3)}
    opt = FusedAdam(params)
    step = opt.step
    cast, opt2, h = amp.initialize(params, opt, opt_level="O2",
                                   enabled=False)
    assert cast is params and opt2.step == step and not h.is_active
    # the vote over a group: outside a process group the name is unbound
    with pytest.raises(NameError, match="unbound axis name"):
        h.scaled_update(opt.tx, params, opt.state, params, h.scaler_state,
                        overflow_reduce_axes=("dp",))


def test_o1_boundary_casting_matches_jax():
    """amp_call and the function wrappers cast as JAX's do under an O1
    policy, and are the identity with none."""
    jpol = jamp.initialize(opt_level="O1").policy
    ppol = amp.initialize(opt_level="O1").policy
    assert amp.current_policy() is ppol
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    cases = [("matmul", (x, x.T)), ("softmax", (x.astype(np.float16),)),
             ("add", (x, x.astype(np.float16)))]
    for op, args in cases:
        jout = jamp.amp_call(op, lambda *a: [t.dtype for t in a],
                             *map(jnp.asarray, args))
        pout = amp.amp_call(op, lambda *a: [t.dtype for t in a],
                            *map(torch.from_numpy, args))
        assert pout == [_dtype(d) for d in jout], op
    half = amp.half_function(lambda t: t.dtype)
    assert half(torch.zeros(2)) == torch.bfloat16
    assert amp.float_function(lambda t: t.dtype)(
        torch.zeros(2, dtype=torch.bfloat16)) == torch.float32
    with amp.casting(None):
        assert amp.current_policy() is ppol
    _amp_state._amp_state.handle = None
    assert amp.current_policy() is None and half(torch.zeros(2)) == (
        torch.float32)
    with amp.casting(jpol.__class__(torch.float32, torch.float16,
                                    torch.float32)):
        assert half(torch.zeros(2)) == torch.float16

    class Mod:
        @staticmethod
        def f(t):
            return t.dtype

    amp.register_half_function(Mod, "f")
    amp.register_half_function(Mod, "f")  # idempotent
    with amp.casting(ppol):
        assert Mod.f(torch.zeros(1)) == torch.bfloat16


# ------------------------------------------------- the slice: Llama O2


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, jparams, port_llama.tiny(), tokens, np.roll(tokens, -1, -1)


def _port_params(jparams):
    return port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def assert_steps_close(port_params, start, jax_params, jax_start, what):
    """Each leaf's displacement from its start, in relative L2."""
    for path, ref in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        keys = [k.key for k in path]
        node, s0, j0 = port_params, start, jax_start
        for key in keys:
            node, s0, j0 = node[key], s0[key], j0[key]
        moved = node.float().numpy() - s0.float().numpy()
        ref_moved = (np.asarray(ref.astype(jnp.float32))
                     - np.asarray(j0.astype(jnp.float32)))
        err = np.linalg.norm(moved - ref_moved) / max(
            np.linalg.norm(ref_moved), 1e-30)
        assert err <= STEP_RTOL, f"{what} {keys}: {err}"


def test_llama_tiny_o2_three_steps_match_jax(tiny):
    """Llama tiny() at O2 with FusedAdam(flat=True), the stateful
    protocol of chip_smoke.py's amp_training phase, 3 steps, against the
    JAX package's same composition: losses, masters and bf16 params."""
    jcfg, jparams, cfg, tokens, targets = tiny
    (jopt, jh), (popt, ph) = _o2_pair(True, jparams, _port_params(jparams))
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    jstart = jopt.master_params
    start = _tree.map_leaves(torch.clone, popt.master_params)
    with pallas_config.force("interpret"):
        for step in range(3):
            jloss, jg = jax.value_and_grad(
                lambda p: jh.scale(jax_llama.loss_fn(
                    p, jbatch, jcfg, tp_axis=None, cp_axis=None,
                    remat=False)))(jopt.params)
            jopt.step(jg)
            live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                    popt.params)
            loss = port_llama.loss_fn(live, batch, cfg, remat=False)
            with ph.scale_loss(loss) as scaled:
                grads = torch.autograd.grad(scaled, _tree.leaves(live))
            popt.step(_tree.unflatten(_tree.paths(live), list(grads)))
            np.testing.assert_allclose(float(scaled.detach()), float(jloss),
                                       rtol=LOSS_RTOL)
            for p, m in zip(_tree.leaves(popt.params),
                            _tree.leaves(popt.master_params)):
                assert torch.equal(p, m.to(p.dtype))
    assert ph.state_dict() == jh.state_dict()
    assert_steps_close(popt.master_params, start, jopt.master_params,
                       jstart, "O2 master")
    assert int(popt.state.count) == 3
    assert list(popt.state.mu) == ["float32"]  # one fp32 slab
