"""Parity of the port's O4 fp8 tier (apex_tpu_torch.amp:
Fp8DelayedScaler over AmaxHistory rings, the fp8 step context and
matmul_amp) with the JAX package's, on the CPU.

Tolerances: the rings, cursors and scales are the same fp32 max, write
and division on both sides: exact, step by step, given the same amax
observations. A forward amax is the max |x| of an input (exact); the
E5M2 amax of a cotangent that both sides compute exactly (the ones of a
sum) is exact too. The products themselves are the fp8 cast (bit for
bit, test_torch_fp8_cast.py) and an fp32 sum of fp8 values taken in
another order: RTOL. The O4 Llama tiny() slice holds losses to
LOSS_RTOL, the rings to RING_RTOL (the lm_head cotangent's amax is a
sum of fp32 products) and each param's displacement to STEP_RTOL in
relative L2, as test_torch_amp.py's O2 slice does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu import amp as jamp
from apex_tpu.amp.scaler import Fp8DelayedScaler as JaxFp8
from apex_tpu.models import llama as jax_llama
from apex_tpu.observability.numerics.history import AmaxHistory as JaxHist
from apex_tpu.ops import pallas_config
from apex_tpu.ops import precision as jax_prec
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import _tree, amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.scaler import Fp8DelayedScaler, current_fp8
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.observability.numerics import AmaxHistory
from apex_tpu_torch.ops import precision
from apex_tpu_torch.optimizers import FusedAdam, opt_state_from_numpy

RTOL = 1e-5
LOSS_RTOL, RING_RTOL, STEP_RTOL = 1e-5, 1e-5, 2e-3
LR = 1e-3


@pytest.fixture(autouse=True)
def _fresh_amp_state():
    yield
    _amp_state._amp_state.handle = None
    from apex_tpu.amp import _amp_state as jstate

    jstate._amp_state.handle = None


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _assert_hist(port_state, jax_state, what):
    np.testing.assert_array_equal(port_state.ring.numpy(),
                                  np.asarray(jax_state.ring), err_msg=what)
    assert int(port_state.cursor) == int(jax_state.cursor), what
    assert int(port_state.filled) == int(jax_state.filled), what
    assert port_state.cursor.device.type == "cpu"


@pytest.mark.parametrize("margin", [0.0, 1.0])
def test_amax_history_matches_jax(margin):
    """Seven updates of a 4-slot ring (it wraps): ring, cursor, filled,
    the rolling amax and the scales, exactly, after each."""
    paths = ["a", "b", "c"]
    jh, ph = JaxHist(paths, length=4), AmaxHistory(paths, length=4)
    js, ps = jh.init(), ph.init(device="cpu")
    for step in range(7):
        amax = np.abs(_rand(3, step, 10.0 ** (step - 3)))
        amax[step % 3] = 0.0  # a row with no signal this step
        js = jh.update(js, jnp.asarray(amax))
        ps = ph.update(ps, torch.from_numpy(amax))
        _assert_hist(ps, js, f"step {step}")
        np.testing.assert_array_equal(ph.amax(ps).numpy(),
                                      np.asarray(jh.amax(js)))
        for fmax in (448.0, 57344.0):
            np.testing.assert_array_equal(
                ph.scales(ps, fmax, margin).numpy(),
                np.asarray(jh.scales(js, fmax, margin)))
    assert ph.state_dict(ps) == jh.state_dict(js)
    _assert_hist(ph.load_state_dict(jh.state_dict(js), device="cpu"), js,
                 "loaded")
    fresh = ph.init(device="cpu")
    assert ph.scales(fresh).tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="different tensor set"):
        AmaxHistory(["x"], 4).load_state_dict(ph.state_dict(ps), "cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        AmaxHistory(paths, 5).load_state_dict(ph.state_dict(ps), "cpu")
    with pytest.raises(ValueError, match=">= 1"):
        AmaxHistory(paths, 0)


class _Observed:
    """A stand-in step context with given amax observations."""

    def __init__(self, fwd, grad, lib):
        self._fwd, self._grad, self._lib = fwd, grad, lib

    def fwd_amax(self):
        return self._lib(self._fwd)

    def grad_amax(self):
        return self._lib(self._grad)


def test_delayed_scaler_sequence_matches_jax():
    """The automaton over 20 steps of seeded observations (duplicate
    site names, history 3, margin 1): the state dict and both scale
    vectors after each update, exactly."""
    sites = ["mlp", "mlp", "head"]
    jf, pf = JaxFp8(sites, history=3, margin=1.0), Fp8DelayedScaler(
        sites, history=3, margin=1.0)
    assert pf.sites == jf.sites == ("mlp#0", "mlp#1", "head#0")
    assert pf.fwd_history.paths == jf.fwd_history.paths
    js, ps = jf.init(), pf.init(device="cpu")
    for step in range(20):
        fwd = np.abs(_rand(6, 50 + step, 2.0 ** (step % 7 - 3)))
        grad = np.abs(_rand(3, 80 + step, 2.0 ** -(step % 5)))
        if step % 4 == 0:
            grad[:] = 0.0  # a forward-only step
        js = jf.update(js, _Observed(fwd, grad, jnp.asarray))
        ps = pf.update(ps, _Observed(fwd, grad, torch.from_numpy))
        assert pf.state_dict(ps) == jf.state_dict(js), f"step {step}"
        for got, want in zip(pf.scales(ps), jf.scales(js)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    loaded = pf.load_state_dict(jf.state_dict(js), device="cpu")
    assert pf.state_dict(loaded) == jf.state_dict(js)
    with pytest.raises(ValueError, match="different site set"):
        Fp8DelayedScaler(["x"]).load_state_dict(jf.state_dict(js), "cpu")
    with pytest.raises(ValueError, match="at least one site"):
        Fp8DelayedScaler([])
    # the vote over a group: outside a process group the name is unbound
    with pytest.raises(NameError, match="unbound axis name"):
        pf.update(ps, _Observed(fwd, grad, torch.from_numpy),
                  reduce_axes=("dp",))


def _two_products(mm):
    def loss(x, w1, w2):
        h = mm(x, w1, name="s")
        return (mm(h, w2, name="t") ** 2).sum() * 0.5

    return loss


def _inputs():
    return _rand((8, 16), 1, 4.0), _rand((16, 32), 2, 0.25), _rand(
        (32, 16), 3, 0.2)


def test_value_and_grad_harvest_matches_jax():
    """Three steps of a two-site function through each package's step
    context and value_and_grad (argnums 0-2): losses, grads and the E5M2
    observations (sums of fp32 products) at RTOL; the forward amaxes and
    so the forward rings exactly."""
    x, w1, w2 = _inputs()
    jf, pf = JaxFp8(["s", "t"], history=4), Fp8DelayedScaler(["s", "t"],
                                                             history=4)
    js, ps = jf.init(), pf.init(device="cpu")
    jloss_fn = _two_products(jax_prec.matmul_amp)
    ploss_fn = _two_products(precision.matmul_amp)
    for step in range(3):
        with jf.step(js) as jctx:
            jl, jg = jctx.value_and_grad(jloss_fn, argnums=(0, 1, 2))(
                jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
        with pf.step(ps) as pctx:
            assert current_fp8() is pctx
            pl, pg = pctx.value_and_grad(ploss_fn, argnums=(0, 1, 2))(
                *map(torch.from_numpy, (x, w1, w2)))
        assert current_fp8() is None and not pctx.skipped_sites
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
        for got, want in zip(pg, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(pctx.fwd_amax().numpy(),
                                      np.asarray(jctx.fwd_amax()))
        np.testing.assert_allclose(pctx.grad_amax().numpy(),
                                   np.asarray(jctx.grad_amax()), rtol=RTOL)
        js, ps = jf.update(js, jctx), pf.update(ps, pctx)
        assert float(ps.fwd.ring[0, step]) == float(np.abs(x).max())
    np.testing.assert_allclose(ps.grad.ring.numpy(),
                               np.asarray(js.grad.ring), rtol=RTOL)
    _assert_hist(ps.fwd, js.fwd, "fwd rings")


def test_context_protocol_details():
    """has_aux with a scalar argnum; an eval forward before the grad and a
    second grad call keep the site registered (merged by max); a
    forward-only step writes its fwd amaxes and zero grad amaxes."""
    x, w1, _ = _inputs()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w1)
    fp8 = Fp8DelayedScaler(["s"], history=2)
    state = fp8.init(device="cpu")
    with fp8.step(state) as ctx:
        ctx.matmul(xt, wt, name="s")  # eval-style forward first

        def loss(a):
            return ctx.matmul(a, wt, name="s").sum(), {"aux": 7}

        (val, aux), grad = ctx.value_and_grad(loss, has_aux=True)(xt)
        ctx.value_and_grad(loss, has_aux=True)(xt * 2)
    assert aux == {"aux": 7} and grad.shape == xt.shape
    assert "s#1" not in ctx.skipped_sites
    new = fp8.update(state, ctx)
    assert float(new.fwd.ring[0, 0]) == float(np.abs(x * 2).max())
    assert float(new.grad.ring[0, 0]) == 1.0  # cotangent of a sum
    with fp8.step(state) as ctx:
        precision.matmul_amp(xt, wt, name="s")
    fwd_only = fp8.update(state, ctx)
    assert float(fwd_only.fwd.ring.max()) > 0
    assert float(fwd_only.grad.ring.max()) == 0.0


def test_unregistered_and_outside_sites():
    """Outside a context matmul_amp is torch.matmul exactly; inside one an
    unregistered site takes the same product (keep_acc: the fp32
    accumulator itself), as JAX's takes its outside product."""
    a = torch.from_numpy(_rand((8, 16), 4, 3.0)).to(torch.bfloat16)
    b = torch.from_numpy(_rand((16, 4), 5)).to(torch.bfloat16)
    assert current_fp8() is None
    assert torch.equal(precision.matmul_amp(a, b, name="x"),
                       torch.matmul(a, b))
    a32, b32 = a.float(), b.float()
    assert torch.equal(precision.matmul_amp(a32, b32),
                       precision.matmul_fp32acc(a32, b32))
    fp8 = Fp8DelayedScaler(["known"], history=2)
    jfp8 = JaxFp8(["known"], history=2)
    ja = jnp.asarray(a.float().numpy(), jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), jnp.bfloat16)
    with fp8.step(fp8.init(device="cpu")) as ctx, jfp8.step(jfp8.init()):
        y = precision.matmul_amp(a, b, name="unknown")
        acc = precision.matmul_amp(a, b, name="unknown", keep_acc=True)
        jacc = jax_prec.matmul_amp(ja, jb, name="unknown", keep_acc=True)
    assert ctx.skipped_sites == ["unknown#0", "unknown#1"]
    assert y.dtype == torch.bfloat16 and acc.dtype == torch.float32
    assert torch.equal(y, torch.matmul(a, b))
    assert torch.equal(acc, precision.matmul_fp32acc(a, b, keep_acc=True))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-6)


def test_for_step_records_the_sites_jax_records():
    x, w1, w2 = _inputs()
    jf = JaxFp8.for_step(_two_products(jax_prec.matmul_amp),
                         *map(jnp.asarray, (x, w1, w2)), history=3)
    with amp.Fp8SiteRecorder() as rec:
        assert current_fp8() is rec
    pf = Fp8DelayedScaler.for_step(_two_products(precision.matmul_amp),
                                   *map(torch.from_numpy, (x, w1, w2)),
                                   history=3)
    assert pf.sites == jf.sites == ("s#0", "t#0") and pf.history == 3
    # the TP linears carry the reference's per-shard site name
    from apex_tpu_torch.transformer.tensor_parallel import (
        column_parallel_linear,
    )

    with amp.Fp8SiteRecorder() as rec:
        column_parallel_linear(torch.from_numpy(x), torch.from_numpy(w1))
    assert rec.sites == ["tp_linear"]


def test_registered_site_under_recompute_raises():
    """A registered site inside a torch.utils.checkpoint region would be
    recomputed in the backward under another ordinal: it raises rather
    than fall back. Unregistered sites recompute their fallback."""
    x, w1, w2 = map(torch.from_numpy, _inputs())

    def region(h):
        return precision.matmul_amp(h, w1, name="s")

    def loss(a):
        h = checkpoint(region, a, use_reentrant=False)
        return precision.matmul_amp(h, w2, name="t").sum()

    fp8 = Fp8DelayedScaler(["s", "t"], history=2)
    with fp8.step(fp8.init(device="cpu")) as ctx:
        with pytest.raises(RuntimeError, match="recomputed"):
            ctx.value_and_grad(loss)(x)
    fp8 = Fp8DelayedScaler(["t"], history=2)
    with fp8.step(fp8.init(device="cpu")) as ctx:
        _, grad = ctx.value_and_grad(loss)(x)
    # the forward's call, then the recompute's in the backward
    assert ctx.skipped_sites == ["s#0", "s#1"] and grad.shape == x.shape


# ------------------------------------------------- the slice: Llama O4


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, jparams, port_llama.tiny(), tokens, np.roll(tokens, -1, -1)


def _o4(jparams, params):
    jopt = JaxFusedAdam(jparams, lr=LR, flat=True)
    jcast, jopt, jh = jamp.initialize(jparams, jopt, opt_level="O4")
    jopt.params = jcast
    jopt.master_params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jcast)
    popt = FusedAdam(params, lr=LR, flat=True)
    cast, popt, ph = amp.initialize(params, popt, opt_level="O4")
    popt.params = cast
    popt.master_params = _tree.map_leaves(lambda p: p.float(), cast)
    return (jopt, jh, jh.init_fp8(["lm_head"], history=16)), (
        popt, ph, ph.init_fp8(["lm_head"], history=16, device="cpu"))


def _jax_o4_step(jopt, jh, jfp8, jbatch, jcfg, remat=False):
    def scaled_loss(p):
        return jh.scale(jax_llama.loss_fn(p, jbatch, jcfg, tp_axis=None,
                                          cp_axis=None, remat=remat))

    with jfp8.step(jh.fp8_state) as ctx:
        loss, grads = ctx.value_and_grad(scaled_loss)(jopt.params)
    jh.fp8_state = jfp8.update(jh.fp8_state, ctx)
    jopt.step(grads)
    return loss


def _port_o4_step(popt, ph, pfp8, batch, cfg, remat=False):
    def scaled_loss(p):
        return ph.scale(port_llama.loss_fn(p, batch, cfg, remat=remat))

    with pfp8.step(ph.fp8_state) as ctx:
        loss, grads = ctx.value_and_grad(scaled_loss)(popt.params)
    ph.fp8_state = pfp8.update(ph.fp8_state, ctx)
    popt.step(grads)
    return loss, ctx


def _batches(tokens, targets):
    return ((jnp.asarray(tokens), jnp.asarray(targets)),
            (torch.from_numpy(tokens).long(),
             torch.from_numpy(targets).long()))


def _assert_rings(ph, jh):
    for part in ("fwd", "grad"):
        p, j = getattr(ph.fp8_state, part), getattr(jh.fp8_state, part)
        np.testing.assert_allclose(p.ring.numpy(), np.asarray(j.ring),
                                   rtol=RING_RTOL, err_msg=part)
        assert int(p.cursor) == int(j.cursor)


def test_llama_tiny_o4_three_steps_match_jax(tiny):
    """Llama tiny() at O4 (lm_head on fp8 under delayed scales, the rest
    as at O2) with FusedAdam(flat=True), 3 steps, against the JAX
    package's same composition: losses, rings and masters."""
    from test_torch_amp import assert_steps_close

    jcfg, jparams, cfg, tokens, targets = tiny
    (jopt, jh, jfp8), (popt, ph, pfp8) = _o4(
        jparams, port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    jbatch, batch = _batches(tokens, targets)
    jstart = jopt.master_params
    start = _tree.map_leaves(torch.clone, popt.master_params)
    with pallas_config.force("interpret"):
        for step in range(3):
            jloss = _jax_o4_step(jopt, jh, jfp8, jbatch, jcfg)
            loss, ctx = _port_o4_step(popt, ph, pfp8, batch, cfg)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL)
            assert not ctx.skipped_sites
            _assert_rings(ph, jh)
    assert ph.state_dict()["fp8"]["steps"] == 3
    assert_steps_close(popt.master_params, start, jopt.master_params,
                       jstart, "O4 master")


def test_llama_tiny_o4_with_remat_equals_without(tiny):
    """lm_head is outside run_layers, so per-layer recompute never
    meets it: remat=True runs and gives the step remat=False gives."""
    jcfg, jparams, cfg, tokens, targets = tiny
    _, batch = _batches(tokens, targets)
    runs = []
    for remat in (False, True):
        _, (popt, ph, pfp8) = _o4(jparams, port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
        loss, _ = _port_o4_step(popt, ph, pfp8, batch, cfg, remat=remat)
        runs.append((float(loss), ph.fp8_state, popt.params))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1].grad.ring, runs[1][1].grad.ring)
    for a, b in zip(_tree.leaves(runs[0][2]), _tree.leaves(runs[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_jax_state_carries_into_the_port(tiny):
    """Two JAX O4 steps, then its FusedAdam.state_dict() and
    amp.state_dict() (with the "fp8" block) pulled to numpy load into a
    port set-up; one more step then matches in both."""
    from test_torch_amp import assert_steps_close

    jcfg, jparams, cfg, tokens, targets = tiny
    (jopt, jh, jfp8), (popt, ph, pfp8) = _o4(
        jparams, port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    jbatch, batch = _batches(tokens, targets)
    with pallas_config.force("interpret"):
        for _ in range(2):
            _jax_o4_step(jopt, jh, jfp8, jbatch, jcfg)
        sd = jax.tree_util.tree_map(np.asarray, jopt.state_dict())
        popt.load_state_dict({"state": opt_state_from_numpy(
            sd["state"], device="cpu")})
        popt.params = port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt.params), device="cpu")
        popt.master_params = port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt.master_params),
            device="cpu")
        amp.load_state_dict(jamp.state_dict())
        assert amp.state_dict() == jamp.state_dict()
        jstart = jopt.master_params
        start = _tree.map_leaves(torch.clone, popt.master_params)
        jloss = _jax_o4_step(jopt, jh, jfp8, jbatch, jcfg)
        loss, _ = _port_o4_step(popt, ph, pfp8, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_rings(ph, jh)
    assert int(popt.state.count) == int(jopt.state.count) == 3
    assert_steps_close(popt.master_params, start, jopt.master_params,
                       jstart, "carried master")


def test_fp8_state_dict_compatibility():
    """A dict without the fp8 block loads into an fp8 handle with the
    rings left fresh; one with it loads into an O2 handle, ignored."""
    h = amp.initialize(opt_level="O4")
    fp8 = h.init_fp8(["lm_head"], history=4, device="cpu")
    h.fp8_state = fp8.update(h.fp8_state, _Observed(
        np.array([2.0, 3.0], np.float32), np.array([5.0], np.float32),
        torch.from_numpy))
    sd = h.state_dict()
    assert sd["fp8"]["fwd"]["ring"][0][0] == 2.0
    legacy = {k: v for k, v in sd.items() if k != "fp8"}
    h.load_state_dict(legacy)
    assert h.state_dict()["fp8"] == sd["fp8"]
    h.fp8_state = fp8.init(device="cpu")
    h.load_state_dict(sd)
    assert h.state_dict() == sd
    o2 = amp.initialize(opt_level="O2")
    o2.load_state_dict(sd)
    assert "fp8" not in o2.state_dict()
