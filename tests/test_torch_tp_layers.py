"""The port's tensor-parallel regions, layers, vocab-parallel cross
entropy and Llama's tensor/sequence-parallel loss
(``apex_tpu_torch.transformer.tensor_parallel``, ``models.llama``) held
against the JAX package's.

One launch of 4 gloo CPU ranks (``tests/torch_megatron_suites.py::
suite_megatron_tp``): the mapping regions at tp 4, the rest at tp 2
(dp 2). The reference runs under ``shard_map`` on the conftest's
simulated devices, or, for gradients of sharded weights, as the dense
computation its own tests hold its shards to
(``tests/run_transformer/test_layers.py:156``).

Each region's forward and vector-Jacobian product is the reference's:
every rank gets its own input (or the replicated one) and its own
cotangent (or the replicated one), as the region's input and output
vary over tp or not; the reference computes ``jax.vjp`` inside
``shard_map``. Tolerances: the regions move values (exact up to the
order of a 4-term sum: 1e-6); layers, CE and Llama fp32 within 2e-5 of
each array's largest value; the bf16 product with fp32 weight gradients
at bf16 rounding (1e-2 relative) for its bf16 outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models import llama as jllama
from apex_tpu.transformer.functional import chunked_ce as jcce
from apex_tpu.transformer.tensor_parallel import cross_entropy as jce
from apex_tpu.transformer.tensor_parallel import layers as jlayers
from apex_tpu.transformer.tensor_parallel import mappings as jmap
from torch_dist_worker import run_ranks
from torch_megatron_suites import MAPPING_CASES

TOL = 2e-5

# region name -> (x shape on a rank, y shape on a rank)
MAP_SHAPES = {
    "copy": ((3, 8), (3, 8)), "reduce": ((3, 8), (3, 8)),
    "scatter": ((3, 8), (3, 2)), "gather": ((3, 2), (3, 8)),
    "reduce_scatter": ((3, 8), (3, 2)),
    "sp_scatter": ((2, 8, 3), (2, 2, 3)), "sp_gather": ((2, 2, 3), (2, 8, 3)),
    "sp_reduce_scatter": ((2, 8, 3), (2, 2, 3)),
}


def _mesh(n, names=("tp",)):
    return Mesh(np.array(jax.devices()[:n]), names)


def _inputs():
    rng = np.random.default_rng(14)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inp = {}
    for name, (_, x_rep, ct_rep, _) in MAPPING_CASES.items():
        xs, ys = MAP_SHAPES[name]
        x = f32(*xs)
        ct = f32(*ys)
        inp[f"map_{name}_x"] = (np.stack([x] * 4) if x_rep
                                else f32(4, *xs))
        inp[f"map_{name}_ct"] = (np.stack([ct] * 4) if ct_rep
                                 else f32(4, *ys))
    inp.update(mlp_x=f32(4, 8), mlp_k1=f32(8, 16) / 3,
               mlp_k2=f32(16, 8) / 4, mlp_b1=f32(16), row_x=f32(4, 16),
               row_b=f32(8), sp_x=f32(2, 4, 8), wg_x=f32(3, 8),
               wg_w=f32(8, 8), wg_ct=f32(3, 8), emb_table=f32(12, 6),
               emb_ids=np.array([[0, 5, 11], [3, 7, 2]], np.int64),
               emb_ct=f32(2, 3, 6), ce_logits=f32(2, 3, 16) * 3,
               ce_target=rng.integers(0, 16, (2, 3)), ce_ct=f32(2, 3),
               cce_hidden=f32(6, 8), cce_weight=f32(8, 32) / 3,
               cce_labels=rng.integers(0, 32, 6), cce_ct=f32(6))
    params = {}
    for prefix, cfg, seed in (("llama", jllama.tiny(), 3),
                              ("moe", jllama.tiny(num_experts=4), 4)):
        params[prefix] = jllama.init_params(jax.random.PRNGKey(seed), cfg)
        for k, v in params[prefix].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    inp[f"{prefix}_p.{k}.{kk}"] = np.asarray(vv)
            else:
                inp[f"{prefix}_p.{k}"] = np.asarray(v)
    tokens = rng.integers(0, 256, (2, 16))
    inp["llama_tokens"] = tokens
    inp["llama_targets"] = np.roll(tokens, -1, axis=-1)
    return inp, params


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    inp, params = _inputs()
    return inp, params, run_ranks("megatron_tp", 4,
                                  tmp_path_factory.mktemp("tp"), inp,
                                  timeout=300)


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------- regions


def _reference_region(name, x_all, ct_all):
    fn, x_rep, ct_rep, kw = MAPPING_CASES[name]
    f = getattr(jmap, fn)

    def body(x, ct):
        x = x if x_rep else x[0]
        ct = ct if ct_rep else ct[0]
        y, vjp = jax.vjp(lambda a: f(a, **kw), x)
        (g,) = vjp(ct)
        return (jmap._to_varying(y[None], "tp"),
                jmap._to_varying(g[None], "tp"))

    return jax.jit(shard_map(
        body, mesh=_mesh(4),
        in_specs=(P() if x_rep else P("tp"), P() if ct_rep else P("tp")),
        out_specs=(P("tp"), P("tp"))))(
        x_all[0] if x_rep else x_all, ct_all[0] if ct_rep else ct_all)


@pytest.mark.parametrize("name", sorted(MAPPING_CASES))
def test_region_forward_and_vjp(tp_ranks, name):
    """Each region's output and input gradient on every rank, against the
    reference's forward and ``jax.vjp`` under ``shard_map`` (tp 4)."""
    inp, _, ranks = tp_ranks
    y, g = _reference_region(name, inp[f"map_{name}_x"],
                             inp[f"map_{name}_ct"])
    for r in range(4):
        np.testing.assert_allclose(ranks[r][f"map_{name}_y"],
                                   np.asarray(y)[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} y rank {r}")
        np.testing.assert_allclose(ranks[r][f"map_{name}_g"],
                                   np.asarray(g)[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} grad rank {r}")


def test_regions_are_identity_without_a_bound_axis():
    import torch

    from apex_tpu_torch.transformer.tensor_parallel import mappings

    x = torch.ones(4, 4)
    for name, (fn, _, _, kw) in MAPPING_CASES.items():
        assert getattr(mappings, fn)(x, **kw) is x, name


# ----------------------------------------------------------------- layers


def _tp_block(full, r, dim, tp=2):
    size = full.shape[dim] // tp
    return np.take(full, np.arange(r * size, (r + 1) * size), axis=dim)


def test_column_row_grads_match_dense(tp_ranks):
    """column -> gelu -> row on tp shards: the loss, each shard's
    gradient and the replicated input's gradient are the dense ones (the
    reference's ``test_tp_linear_grads_match_dense``), and the loss is
    the reference's tp computation's."""
    inp, _, ranks = tp_ranks
    x, k1, k2 = (jnp.asarray(inp[k]) for k in ("mlp_x", "mlp_k1", "mlp_k2"))

    def dense_loss(x, k1, k2):
        return jnp.mean((jax.nn.gelu(x @ k1) @ k2) ** 2)

    loss = dense_loss(x, k1, k2)
    gx, gk1, gk2 = jax.grad(dense_loss, argnums=(0, 1, 2))(x, k1, k2)

    def tp_loss(k1l, k2l):
        h = jax.nn.gelu(jlayers.column_parallel_linear(
            x, k1l, gather_output=False))
        y = jlayers.row_parallel_linear(h, k2l, input_is_parallel=True)
        return jnp.mean(y ** 2)

    ref_tp = jax.jit(shard_map(tp_loss, mesh=_mesh(2),
                               in_specs=(P(None, "tp"), P("tp", None)),
                               out_specs=P()))(k1, k2)
    np.testing.assert_allclose(float(ref_tp), float(loss), rtol=1e-5)
    for rank, out in enumerate(ranks):
        r = rank % 2
        np.testing.assert_allclose(out["mlp_loss"], float(ref_tp), rtol=1e-5)
        _close(out["mlp_gx"], gx, ("gx", rank))
        _close(out["mlp_gk1"], _tp_block(np.asarray(gk1), r, 1), ("gk1", rank))
        _close(out["mlp_gk2"], _tp_block(np.asarray(gk2), r, 0), ("gk2", rank))


def test_gather_output_bias_and_scattered_input(tp_ranks):
    """``gather_output=True`` with the bias, and ``input_is_parallel=False``
    with the replicated bias, against the reference's per-shard functions
    under ``shard_map``."""
    inp, _, ranks = tp_ranks
    col = jax.jit(shard_map(
        lambda x, k, b: jlayers.column_parallel_linear(x, k, b,
                                                       gather_output=True),
        mesh=_mesh(2), in_specs=(P(), P(None, "tp"), P("tp")),
        out_specs=P(), check_vma=False))(inp["mlp_x"], inp["mlp_k1"], inp["mlp_b1"])
    row = jax.jit(shard_map(
        lambda x, k, b: jlayers.row_parallel_linear(x, k, b,
                                                    input_is_parallel=False),
        mesh=_mesh(2), in_specs=(P(), P("tp", None), P()),
        out_specs=P(), check_vma=False))(inp["row_x"], inp["mlp_k2"], inp["row_b"])
    for out in ranks:
        _close(out["col_gathered"], col, "column gathered")
        _close(out["row_scatter_in"], row, "row scattered input")


def test_sequence_parallel_linears(tp_ranks):
    """The column linear's all-gather of the sequence and the row
    linear's reduce-scatter, against the reference's."""
    inp, _, ranks = tp_ranks

    def fn(x, k1, k2):
        h = jlayers.column_parallel_linear(x, k1, gather_output=False,
                                           sequence_parallel_enabled=True,
                                           seq_dim=1)
        return jlayers.row_parallel_linear(h, k2,
                                           sequence_parallel_enabled=True,
                                           seq_dim=1)

    y = jax.jit(shard_map(fn, mesh=_mesh(2),
                          in_specs=(P(None, "tp"), P(None, "tp"),
                                    P("tp", None)),
                          out_specs=P(None, "tp")))(
        inp["sp_x"], inp["mlp_k1"], inp["mlp_k2"])
    for rank, out in enumerate(ranks):
        _close(out["sp_y"], _tp_block(np.asarray(y), rank % 2, 1),
               ("sp", rank))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def test_fp32_wgrad_product(tp_ranks):
    """``gradient_accumulation_fusion``: a bf16 product of the fp32
    master weight whose weight gradient comes back fp32 (``layers.py:250``):
    the output and input gradient at bf16 rounding, the weight gradient
    in fp32, against the same bf16-exact values in fp32 (jax 0.9's CPU dot
    takes no bf16 x bf16 = f32)."""
    inp, _, ranks = tp_ranks
    x = _bf16(inp["wg_x"])
    for rank, out in enumerate(ranks):
        r = rank % 2
        w = _tp_block(inp["wg_w"], r, 1, 2)
        ct = _bf16(_tp_block(inp["wg_ct"], r, 1, 2))
        np.testing.assert_array_equal(
            out["wg_dtypes"], ["torch.bfloat16", "torch.bfloat16",
                               "torch.float32"])
        np.testing.assert_allclose(out["wg_y"], x @ _bf16(w), rtol=1e-2,
                                   atol=1e-2)
        gx = sum(_bf16(_tp_block(inp["wg_ct"], q, 1, 2))
                 @ _bf16(_tp_block(inp["wg_w"], q, 1, 2)).T for q in range(2))
        np.testing.assert_allclose(out["wg_gx"], gx, rtol=1e-2, atol=2e-2)
        _close(out["wg_gw"], x.T @ ct, ("wgrad", rank), tol=1e-6)


def test_vocab_parallel_embedding(tp_ranks):
    """Masked local lookup and sum over tp against the reference's, and
    each shard's table gradient against the dense one."""
    inp, _, ranks = tp_ranks
    ids, table = jnp.asarray(inp["emb_ids"]), jnp.asarray(inp["emb_table"])
    y = jax.jit(shard_map(
        lambda i, t: jlayers.vocab_parallel_embedding(i, t), mesh=_mesh(2),
        in_specs=(P(), P("tp", None)), out_specs=P(),
        check_vma=False))(ids, table)
    gt = jax.grad(lambda t: jnp.sum(t[ids] * inp["emb_ct"]))(table)
    for rank, out in enumerate(ranks):
        _close(out["emb_y"], y, "embedding")
        _close(out["emb_gt"], _tp_block(np.asarray(gt), rank % 2, 0),
               ("table grad", rank))


def test_module_forms(tp_ranks):
    """ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding:
    the outputs equal the dense product of the master weight each rank
    drew, the shards are its slices, and the partition metadata."""
    _, _, ranks = tp_ranks
    for rank, out in enumerate(ranks):
        r = rank % 2
        _close(out["mod_col"], out["mod_col_ref"], "column module")
        _close(out["mod_row"], out["mod_row_ref"], "row module")
        assert out["mod_col_weight"].shape == (8, 8)
        np.testing.assert_array_equal(out["mod_emb_range"], [6 * r,
                                                             6 * r + 6])
        assert list(out["mod_specs"]) == [
            "{'weight': (None, 'tp'), 'bias': ('tp',)}",
            "{'weight': ('tp', None), 'bias': (None,)}"]
        np.testing.assert_array_equal(out["mod_dup"], [True, False])
    np.testing.assert_array_equal(ranks[0]["mod_emb"], ranks[1]["mod_emb"])


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_vocab_parallel_cross_entropy(tp_ranks, ls):
    """Losses against the reference's vocab-parallel CE under
    ``shard_map`` (tp 2), the logits' shard gradients against its
    unsharded VJP."""
    inp, _, ranks = tp_ranks
    logits = jnp.asarray(inp["ce_logits"])
    target = jnp.asarray(inp["ce_target"])
    loss = jax.jit(shard_map(
        lambda lg: jce.vocab_parallel_cross_entropy(lg, target, ls),
        mesh=_mesh(2), in_specs=(P(None, None, "tp"),), out_specs=P(),
        check_vma=False))(logits)
    _, vjp = jax.vjp(lambda lg: jce.vocab_parallel_cross_entropy(
        lg, target, ls, axis_name="none"), logits)
    (grad,) = vjp(jnp.asarray(inp["ce_ct"]))
    for rank, out in enumerate(ranks):
        _close(out[f"ce_{ls}_loss"], loss, ("ce loss", ls))
        _close(out[f"ce_{ls}_grad"], _tp_block(np.asarray(grad), rank % 2, 2),
               ("ce grad", ls, rank))


def test_chunked_ce_vocab_parallel(tp_ranks):
    """The chunked lm-head CE with ``tp_axis``: losses against the
    reference's tp path under ``shard_map``, gradients against its
    unsharded VJP (the hidden's whole on every rank, the weight's
    shard)."""
    inp, _, ranks = tp_ranks
    h, w = jnp.asarray(inp["cce_hidden"]), jnp.asarray(inp["cce_weight"])
    labels = jnp.asarray(inp["cce_labels"])
    loss = jax.jit(shard_map(
        lambda hh, ww: jcce.chunked_lm_cross_entropy(hh, ww, labels, 4,
                                                     tp_axis="tp"),
        mesh=_mesh(2), in_specs=(P(), P(None, "tp")), out_specs=P(),
        check_vma=False))(h, w)
    _, vjp = jax.vjp(lambda hh, ww: jcce.chunked_lm_cross_entropy(
        hh, ww, labels, 8), h, w)
    gh, gw = vjp(jnp.asarray(inp["cce_ct"]))
    for rank, out in enumerate(ranks):
        _close(out["cce_loss"], loss, "chunked loss")
        _close(out["cce_gh"], gh, ("chunked d hidden", rank))
        _close(out["cce_gw"], _tp_block(np.asarray(gw), rank % 2, 1),
               ("chunked d weight", rank))


# ------------------------------------------------------------------ llama


def _reference_tp_loss(params, batch, cfg, sp, chunks):
    specs = jllama.param_specs(cfg)
    pspecs = jax.tree_util.tree_map(lambda s: s, specs,
                                    is_leaf=lambda s: isinstance(s, P))

    def fn(p):
        loss = jllama.loss_fn(p, batch, cfg, tp_axis="tp", cp_axis=None,
                              sequence_parallel=sp, remat=False,
                              vocab_chunks=chunks)
        return jax.lax.pmean(jmap._to_varying(loss, "tp"), "tp")

    return jax.jit(shard_map(fn, mesh=_mesh(2), in_specs=(pspecs,),
                             out_specs=P()))(params)


@pytest.mark.parametrize("model,sp,chunks", [
    ("llama", False, 0), ("llama", True, 0), ("llama", False, 4),
    ("llama", True, 4), ("moe", False, 0), ("moe", True, 0)])
def test_llama_loss_tp(tp_ranks, model, sp, chunks):
    """``llama.loss_fn(tp_axis='tp', sequence_parallel=...)`` on tp 2
    shards (full lm head and ``vocab_chunks``; the MoE MLP, its experts
    whole on every tp rank): the loss against the reference's under
    ``shard_map``, each rank's shard gradients (the norm scales summed
    over tp under sequence parallelism) against the single-device
    gradient's blocks. The MoE routes are first checked to sit 1e-5 or
    more from a tie."""
    inp, params, ranks = tp_ranks
    params = params[model]
    cfg = jllama.tiny(num_experts=4) if model == "moe" else jllama.tiny()
    batch = (jnp.asarray(inp["llama_tokens"]),
             jnp.asarray(inp["llama_targets"]))
    if model == "moe":
        _check_route_margins(params, batch, cfg)
    else:
        ref_loss = _reference_tp_loss(params, batch, cfg, sp, chunks or None)
    loss, grads = jax.value_and_grad(lambda p: jllama.loss_fn(
        p, batch, cfg, tp_axis=None, cp_axis=None, ep_axis=None,
        remat=False, vocab_chunks=chunks or None))(params)
    if model != "moe":
        np.testing.assert_allclose(float(ref_loss), float(loss), rtol=1e-5)
    specs = jllama.param_specs(cfg)
    tag = f"{model}_{int(sp)}_{chunks}"
    for rank, out in enumerate(ranks):
        r = rank % 2
        np.testing.assert_allclose(out[f"{tag}_loss"], float(loss),
                                   rtol=1e-5)
        for key, g in [(k, grads[k]) for k in ("embed", "final_norm",
                                               "lm_head")] + \
                list(grads["layers"].items()):
            spec = (specs[key] if key in specs else specs["layers"][key])
            want = np.asarray(g)
            for dim, axis in enumerate(tuple(spec)):
                if axis == "tp":
                    want = _tp_block(want, r, dim)
            _close(out[f"{tag}_g_{key}"], want, (tag, rank, key))


def test_llama_loss_tp_axis_none_is_single_device(tp_ranks):
    """``llama.loss_fn(tp_axis=None)`` on the full params in a process
    whose tp group is bound runs the single-device path: the loss and
    every gradient against the reference's single-device ones."""
    inp, params, ranks = tp_ranks
    cfg = jllama.tiny()
    batch = (jnp.asarray(inp["llama_tokens"]),
             jnp.asarray(inp["llama_targets"]))
    loss, grads = jax.value_and_grad(lambda p: jllama.loss_fn(
        p, batch, cfg, tp_axis=None, cp_axis=None, ep_axis=None,
        remat=False))(params["llama"])
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out["unbound_loss"], float(loss),
                                   rtol=1e-5)
        for key, g in [(k, grads[k]) for k in ("embed", "final_norm",
                                               "lm_head")] + \
                list(grads["layers"].items()):
            _close(out["unbound_g_" + key], g, ("unbound", rank, key))


def _check_route_margins(params, batch, cfg):
    """Every token's top-k router choice in every layer beats the next
    expert by at least 1e-5 in a single-device port forward (recorded on
    the port's side, as ``test_torch_llama_moe.py`` does: routing is
    discrete, and a near tie could flip between two roundings)."""
    from apex_tpu_torch.models import llama as port_llama
    from apex_tpu_torch.transformer import moe

    seen = []
    real = moe.router_gates

    def gates(logits, mcfg, with_stats=False):
        seen.append(logits.detach())
        return real(logits, mcfg, with_stats)

    moe.router_gates = gates
    try:
        port_params = port_llama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), device="cpu")
        port_cfg = port_llama.tiny(num_experts=cfg.num_experts)
        port_llama.forward(port_params, torch.from_numpy(
            np.asarray(batch[0])).long(), port_cfg, tp_axis=None)
    finally:
        moe.router_gates = real
    assert len(seen) == cfg.num_layers
    for logits in seen:
        top = torch.sort(logits.reshape(-1, logits.shape[-1]), -1).values
        margin = top[:, -cfg.moe_top_k] - top[:, -cfg.moe_top_k - 1]
        assert float(margin.min()) >= 1e-5, float(margin.min())


def test_llama_heads_must_split_over_tp(tp_ranks):
    _, _, ranks = tp_ranks
    assert "tp=2 must divide" in str(ranks[0]["llama_heads_error"])
    # a bound context-parallel axis of one rank: the ring of one block
    # gives the flash path's loss bit for bit
    for res in ranks:
        np.testing.assert_array_equal(res["llama_cp1_loss"],
                                      res["llama_tp_loss"])
