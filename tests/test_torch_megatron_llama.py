"""The port's 3-D-parallel Llama step (``apex_tpu_torch.examples.
llama_train``) held against the JAX package's.

The port runs on 8 gloo CPU ranks (pp 2 x dp 2 x tp 2, one launch,
``tests/torch_megatron_suites.py::suite_megatron_step``): the example's
tiny config (``examples/llama_train.py:129-132``), sequence parallelism
on and off, ``fused_adam`` in tree and flat mode, 3 steps. The
reference is the example's ``train_step`` (``:166-245``) under
``shard_map`` on the conftest's 8 simulated devices, written out here
(the example builds it inside ``main``), with Adam applied to the full
tree (Adam is elementwise, so each rank's shard of the result is what
that rank's update gives).

The reference's gradients carry a constant factor per leaf, which is
removed before the comparison: the example makes every param varying
over every mesh axis (``vary_all``, ``:182-186``), and under jax's
varying-value typing that cast's transpose already sums each leaf's
gradient over those axes; its explicit reductions (``:228-235``) then
sum (or mean) the summed gradient again. So the dp mean multiplies every
leaf by dp, the pp sum the io leaves by pp, and the tp sum the norm
scales under sequence parallelism by tp. The port's reductions, on local
gradients, give the gradient of the global batch's mean loss; the
factors are checked to be exactly those (``test_reference_factors``).

Each step is held from the port's own state (its shards and moments
before the step), because Adam at eps 1e-8 turns a gradient's rounding
into an update difference up to lr / eps times larger where |g| is
small (1e-5 of a leaf's largest value after one step, at 1.5e-6
relative gradient agreement): the reference step's loss and gradients
at the port's shards, then the reference's Adam on the port's gradients
and moments, against the port's shards and moments after the step. The
two packages' own 3-step trajectories are compared by their losses.

Tolerance: the loss, every gradient shard, the shards and moments after
each step within 1e-5 of each array's largest value (fp32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models import llama as jllama
from apex_tpu.optimizers import fused_adam as jfused_adam
from apex_tpu.transformer.pipeline_parallel.schedules import (
    pipelined_forward as jpipelined_forward,
)
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jce,
)
from apex_tpu.transformer.tensor_parallel.mappings import _to_varying
from torch_dist_worker import run_ranks
from torch_megatron_suites import STEP_CASES

PP, DP, TP = 2, 2, 2
M, MB, SEQ, LR, STEPS = 4, 2, 32, 1e-3, 3
TOL = 1e-5
IO = ("embed", "final_norm", "lm_head")


def _cfg():
    return jllama.tiny(num_layers=2 * PP, num_heads=2 * TP, num_kv_heads=TP,
                       hidden_size=32 * TP, intermediate_size=64 * TP,
                       vocab_size=128 * TP, max_seq_len=SEQ)


def _factors(sp):
    """The constant each reference gradient leaf carries (see the module
    docstring)."""
    stage = {k: DP * (TP if sp and k.endswith("norm") else 1)
             for k in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
                       "wg", "wu", "wd")}
    io = {k: PP * DP * (TP if sp and k == "final_norm" else 1) for k in IO}
    return stage, io


@functools.lru_cache(maxsize=None)
def _reference_grads_fn(sp):
    """The example's loss and gradient reductions (``:166-235``),
    compiled once for each ``sp``."""
    cfg, mesh = _cfg(), _mesh()
    def psum(t, ax):
        return jax.lax.psum(_to_varying(t, ax), ax)

    def pmean(t, ax):
        return jax.lax.pmean(_to_varying(t, ax), ax)

    def fn(stage_params, io_params, tokens, targets):
        pp_rank = jax.lax.axis_index("pp")
        pp_size = jax.lax.axis_size("pp")

        def vary_all(t):
            for ax in ("pp", "dp", "tp"):
                t = jax.tree_util.tree_map(
                    lambda a, ax=ax: _to_varying(a, ax), t)
            return t

        def total_loss(trees):
            stage, io = trees
            stage = jax.tree_util.tree_map(lambda a: a[0], stage)
            stage, io = vary_all(stage), vary_all(io)
            x_mb = vary_all(jax.vmap(lambda tok: jllama.embed(
                io, tok, cfg, tp_axis="tp", sequence_parallel=sp))(tokens))
            positions = jllama._positions(MB, SEQ, None)

            def stage_fn(sp_params, x):
                return jllama.stage_fn(sp_params, x, cfg, positions,
                                       tp_axis="tp", cp_axis=None,
                                       sequence_parallel=sp)

            outs = jpipelined_forward(stage_fn, stage, x_mb, axis_name="pp",
                                      remat=True)

            def mb_loss(o, t):
                logits = jllama.lm_head(io, o, cfg, tp_axis="tp",
                                        sequence_parallel=sp)
                return jnp.mean(jce(logits, t, axis_name="tp"))

            losses = jnp.mean(jax.vmap(mb_loss)(outs, targets))
            local = jnp.where(pp_rank == pp_size - 1, losses, 0.0)
            return jax.lax.psum(local, "pp")

        loss, (g_stage, g_io) = jax.value_and_grad(total_loss)(
            (stage_params, io_params))
        g_stage = jax.tree_util.tree_map(lambda g: pmean(g, "dp"), g_stage)
        g_io = jax.tree_util.tree_map(
            lambda g: pmean(psum(g, "pp"), "dp"), g_io)
        if sp:
            g_stage = {k: (psum(v, "tp") if k.endswith("norm") else v)
                       for k, v in g_stage.items()}
            g_io = {k: (psum(v, "tp") if k == "final_norm" else v)
                    for k, v in g_io.items()}
        loss = jax.lax.pmean(jax.lax.pmean(loss, "dp"), "tp")
        return g_stage, g_io, loss

    lp = jllama.param_specs(cfg)["layers"]
    stage_specs = {k: P("pp", *lp[k]) for k in lp}
    io_specs = {"embed": P("tp", None), "final_norm": P(),
                "lm_head": P(None, "tp")}
    return jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(stage_specs, io_specs, P(None, "dp", None),
                  P(None, "dp", None)),
        out_specs=(stage_specs, io_specs, P())))


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(PP, DP, TP),
                ("pp", "dp", "tp"))


def _reference_grads(fn, tree, tokens, sp):
    """The reference step's loss and factor-corrected gradients (full
    layout), and the raw ones."""
    f_stage, f_io = _factors(sp)
    tok = jnp.asarray(tokens)
    gs, gi, loss = fn(tree["stage"], tree["io"], tok,
                      jnp.roll(tok, -1, axis=-1))
    g = {"stage": {k: v / f_stage[k] for k, v in gs.items()},
         "io": {k: v / f_io[k] for k, v in gi.items()}}
    return float(loss), g, (gs, gi)


def _reference_run(params, tokens, sp, flat):
    """The reference's own 3-step trajectory: each step's loss and
    corrected gradients, the params after the last, the raw gradients."""
    fn = _reference_grads_fn(sp)
    tree = {"stage": jllama.split_stages(params, PP),
            "io": {k: params[k] for k in IO}}
    tx = jfused_adam(lr=LR, flat=flat)
    state = tx.init(tree)
    losses, grads, raw = [], [], []
    for it in range(tokens.shape[0]):
        loss, g, r = _reference_grads(fn, tree, tokens[it], sp)
        losses.append(loss)
        grads.append(jax.tree_util.tree_map(np.asarray, g))
        raw.append(r)
        updates, state = tx.update(g, state, tree)
        tree = jax.tree_util.tree_map(jnp.add, tree, updates)
    return losses, grads, jax.tree_util.tree_map(np.asarray, tree), raw


def _assemble(ranks, key, spec, shape):
    """The full array of leaf ``key`` from every rank's block (ranks that
    hold the same block agree; the first one's is read)."""
    full = np.zeros(shape, np.float32)
    for rank, out in enumerate(ranks):
        idx = dict(zip(("pp", "dp", "tp"), _coords(rank)))
        block = out[key]
        if spec and spec[0] == "pp":
            block = block[None]
        sl = []
        for dim, axis in enumerate(spec):
            if axis is None:
                sl.append(slice(None))
            else:
                size = block.shape[dim]
                sl.append(slice(idx[axis] * size, (idx[axis] + 1) * size))
        full[tuple(sl)] = block
    return full


def _port_tree(ranks, fmt, params):
    """The port's tree (reference layout) of leaves ``fmt.format(k)``."""
    s_specs, i_specs = _specs()
    stages = jllama.split_stages(params, PP)
    return {"stage": {k: _assemble(ranks, fmt.format(k), spec,
                                   stages[k].shape)
                      for k, spec in s_specs.items()},
            "io": {k: _assemble(ranks, fmt.format(k), spec, params[k].shape)
                   for k, spec in i_specs.items()}}


def _inputs():
    cfg = _cfg()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    # one fixed batch, as the example's --fixed-data: the loss must fall
    tokens = np.repeat(rng.integers(0, cfg.vocab_size, (1, M, MB * DP, SEQ)),
                       STEPS, axis=0)
    flat = {"M": np.array(M), "mb": np.array(MB), "seq": np.array(SEQ),
            "lr": np.array(LR), "tokens": tokens.astype(np.int64)}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"p.{k}.{kk}"] = np.asarray(vv)
        else:
            flat[f"p.{k}"] = np.asarray(v)
    return params, tokens, flat


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    params, tokens, flat = _inputs()
    ranks = run_ranks("megatron_step", 8, tmp_path_factory.mktemp("m3d"),
                      flat, timeout=600)
    return params, tokens, ranks


def _coords(rank):
    """(pp, dp, tp) of a global rank: tp fastest, pp outermost."""
    return rank // (DP * TP), (rank // TP) % DP, rank % TP


def _block(full, spec, coords):
    pp, dp, tp = coords
    idx = {"pp": pp, "dp": dp, "tp": tp}
    out = full
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = {"pp": PP, "dp": DP, "tp": TP}[axis]
        size = full.shape[dim] // n
        out = np.take(out, np.arange(idx[axis] * size,
                                     (idx[axis] + 1) * size), axis=dim)
    return out


def _specs():
    cfg = _cfg()
    lp = jllama.param_specs(cfg)["layers"]
    stage = {k: ("pp",) + tuple(lp[k]) for k in lp}
    io = {"embed": ("tp", None), "final_norm": (), "lm_head": (None, "tp")}
    return stage, io


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


def _check_blocks(ranks, fmt, want, what):
    """Every rank's block of every leaf against the full ``want`` tree."""
    s_specs, i_specs = _specs()
    for rank, out in enumerate(ranks):
        c = _coords(rank)
        for k, spec in s_specs.items():
            _close(out[fmt.format(k)], _block(want["stage"][k], spec, c)[0],
                   (what, rank, k))
        for k, spec in i_specs.items():
            _close(out[fmt.format(k)], _block(want["io"][k], spec, c),
                   (what, rank, k))


@pytest.mark.parametrize("sp,flat", STEP_CASES,
                         ids=[f"sp{int(a)}-flat{int(b)}"
                              for a, b in STEP_CASES])
def test_3d_step_matches_reference(step_runs, sp, flat):
    """Each step from the port's own state: the loss and every gradient
    shard of the reference step at the port's shards; then the
    reference's Adam on the port's gradients and moments against the
    port's shards and moments after the step (the last step's shards are
    the params after 3 steps). The reference's own 3-step trajectory
    gives the same losses."""
    params, tokens, ranks = step_runs
    fn = _reference_grads_fn(sp)
    tx = jfused_adam(lr=LR)  # tree mode: elementwise the same as flat
    tag = f"{int(sp)}{int(flat)}"
    zeros = jax.tree_util.tree_map(
        np.zeros_like, _port_tree(ranks, tag + "_p0_{}", params))
    m_prev, v_prev = zeros, zeros
    port_losses = []
    for it in range(STEPS):
        tree = _port_tree(ranks, f"{tag}_p{it}_" + "{}", params)
        loss, g, _ = _reference_grads(fn, tree, tokens[it], sp)
        for out in ranks:
            np.testing.assert_allclose(out[f"{tag}_loss{it}"], loss,
                                       rtol=TOL)
        port_losses.append(float(ranks[0][f"{tag}_loss{it}"]))
        _check_blocks(ranks, f"{tag}_g{it}_" + "{}",
                      jax.tree_util.tree_map(np.asarray, g), ("grad", it))
        # Adam from the port's own gradients: at eps 1e-8 an update
        # multiplies a gradient's rounding by up to lr / eps where |g| is
        # small, so each link is held on its own
        g_port = _port_tree(ranks, f"{tag}_g{it}_" + "{}", params)
        state = type(tx.init(tree))(count=jnp.asarray(it, jnp.int32),
                                    mu=m_prev, nu=v_prev)
        updates, state = tx.update(g_port, state, tree)
        after = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b),
                                       tree, updates)
        _check_blocks(ranks, f"{tag}_p{it + 1}_" + "{}", after,
                      ("params", it))
        for part, want in (("m", state.mu), ("v", state.nu)):
            _check_blocks(ranks, f"{tag}_{part}{it}_" + "{}",
                          jax.tree_util.tree_map(np.asarray, want),
                          (part, it))
        m_prev = _port_tree(ranks, f"{tag}_m{it}_" + "{}", params)
        v_prev = _port_tree(ranks, f"{tag}_v{it}_" + "{}", params)
    losses, _, _, _ = _reference_run(params, tokens, sp, flat)
    np.testing.assert_allclose(port_losses, losses, rtol=TOL)
    assert losses[-1] < losses[0]


def test_reference_factors(step_runs):
    """The reference's raw gradients are the port's times the per-leaf
    factors (the double reduction the module docstring describes), and
    the port's equal the single-device gradient of the global batch's
    mean loss."""
    params, tokens, ranks = step_runs
    cfg = _cfg()
    tok = jnp.asarray(tokens[0])
    full_loss = jax.value_and_grad(lambda p: jllama.loss_fn(
        p, (tok.reshape(-1, SEQ), jnp.roll(tok, -1, axis=-1).reshape(-1, SEQ)),
        cfg, tp_axis=None, cp_axis=None, remat=False))
    loss, g = full_loss(params)
    dense = {"stage": jllama.split_stages(g, PP),
             "io": {k: g[k] for k in IO}}
    _, _, _, raw = _reference_run(params, tokens[:1], True, False)
    f_stage, f_io = _factors(True)
    for k, v in raw[0][0].items():
        ratio = np.asarray(v) / f_stage[k]
        np.testing.assert_allclose(ratio, np.asarray(dense["stage"][k]),
                                   rtol=1e-4, atol=1e-6 * float(
                                       np.abs(dense["stage"][k]).max()))
    for k, v in raw[0][1].items():
        np.testing.assert_allclose(np.asarray(v) / f_io[k],
                                   np.asarray(dense["io"][k]), rtol=1e-4,
                                   atol=1e-6 * float(
                                       np.abs(dense["io"][k]).max()))
    s_specs, i_specs = _specs()
    out = ranks[0]  # pp 0, dp 0, tp 0
    np.testing.assert_allclose(out["10_loss0"], float(loss), rtol=TOL)
    assert set(_factors(True)[1].values()) == {PP * DP, PP * DP * TP}
    for k, spec in s_specs.items():
        _close(out[f"10_g0_{k}"],
               _block(np.asarray(dense["stage"][k]), spec, (0, 0, 0))[0], k)
