"""The port's side of the Megatron-slice tests: suites that run on every
rank of a gloo group on the CPU (through ``torch_dist_worker.run_ranks``)
and save what they computed. Inputs are the test's numpy arrays; each
suite says which it reads. This file imports torch and the port, never
JAX.
"""

from __future__ import annotations

import warnings

import numpy as np

from torch_dist_worker import _error, _np, _t

# region name -> (function name in mappings, x replicated?, ct
# replicated?, extra kwargs)
MAPPING_CASES = {
    "copy": ("copy_to_tensor_model_parallel_region", True, False, {}),
    "reduce": ("reduce_from_tensor_model_parallel_region", False, True, {}),
    "scatter": ("scatter_to_tensor_model_parallel_region", True, False, {}),
    "gather": ("gather_from_tensor_model_parallel_region", False, False, {}),
    "reduce_scatter": ("reduce_scatter_to_tensor_model_parallel_region",
                       False, False, {}),
    "sp_scatter": ("scatter_to_sequence_parallel_region", True, False,
                   {"seq_dim": 1}),
    "sp_gather": ("gather_from_sequence_parallel_region", False, False,
                  {"seq_dim": 1}),
    "sp_reduce_scatter": ("reduce_scatter_to_sequence_parallel_region",
                          False, False, {"seq_dim": 1}),
}


def _coords():
    from apex_tpu_torch.distributed import backend as B

    return {a: (B.get_rank(a), B.get_world_size(a))
            for a in ("pp", "dp", "tp")}


# ------------------------------------------------------------ state

def suite_megatron_state(rank, n, inp, directory):
    """parallel_state on 8 ranks (tp 2, pp 2, dp 2), the rank-bound
    helpers: data broadcast, 1-D split and gather, the GradScaler vote,
    RNG streams, dp loss averaging, the params' L2 norm, the embedding
    all-reduce."""
    import torch

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer import utils as tu
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.pipeline_parallel import p2p
    from apex_tpu_torch.transformer.pipeline_parallel import utils as pu
    from apex_tpu_torch.transformer.tensor_parallel import data as tdata
    from apex_tpu_torch.transformer.tensor_parallel import random as trand

    out = {}
    out["before_init"] = np.array([ps.model_parallel_is_initialized(),
                                   ps.is_unitialized(),
                                   ps.get_tensor_model_parallel_rank()])
    out["indivisible"] = np.array(_error(
        lambda: ps.initialize_model_parallel(3, 1)))
    mesh = ps.initialize_model_parallel(2, 2)
    out["mesh"] = np.array([mesh.shape[a] for a in ps.AXES])
    out["sizes"] = np.array([
        ps.get_tensor_model_parallel_world_size(),
        ps.get_pipeline_model_parallel_world_size(),
        ps.get_data_parallel_world_size(),
        ps.get_context_parallel_world_size()])
    out["ranks"] = np.array([
        ps.get_tensor_model_parallel_rank(),
        ps.get_pipeline_model_parallel_rank(),
        ps.get_data_parallel_rank(), ps.get_context_parallel_rank()])
    out["rank_info"] = np.array(ps.get_rank_info())
    out["global"] = np.array([
        ps._flat_rank(), ps.get_tensor_model_parallel_src_rank(),
        ps.get_data_parallel_src_rank(),
        ps.get_pipeline_model_parallel_first_rank(),
        ps.get_pipeline_model_parallel_last_rank(),
        ps.get_pipeline_model_parallel_next_rank(),
        ps.get_pipeline_model_parallel_prev_rank()])
    out["stage_flags"] = np.array([
        ps.is_pipeline_first_stage(), ps.is_pipeline_last_stage(),
        ps.is_rank_in_embedding_group(),
        ps.is_rank_in_position_embedding_group()])
    out["groups"] = np.array([
        ps.get_tensor_model_parallel_group(),
        ps.get_pipeline_model_parallel_group(),
        ps.get_data_parallel_group(), ps.get_context_parallel_group(),
        ps.get_embedding_group(), "+".join(ps.get_model_parallel_group())])
    # each group's members, read back through an all-gather of ranks
    me = torch.tensor([float(rank)])
    out["members"] = np.stack([
        _np(B.all_gather(me, axis)) for axis in ("tp", "pp", "dp")])
    out["data_members"] = _np(B.all_gather(me, "data"))

    # broadcast_data: tp-rank 0's batch on every rank of its tp group
    data = {"text": torch.full((2, 3), rank, dtype=torch.int64),
            "mask": torch.full((4,), 10 + rank, dtype=torch.int64)}
    got = tdata.broadcast_data(["text", "mask"], data, torch.int64)
    out["bcast_text"], out["bcast_mask"] = _np(got["text"]), _np(got["mask"])
    out["bcast_dtype_error"] = np.array(_error(
        lambda: tdata.broadcast_data(["text"], data, torch.float32)))

    # split the replicated 1-D tensor over tp, gather it back
    full = _t(inp["split_1d"])
    part = tu.split_tensor_into_1d_equal_chunks(full, "tp")
    out["split_1d"] = _np(part)
    out["gather_1d"] = _np(tu.gather_split_1d_tensor(part, "tp"))

    # GradScaler: rank 5 alone overflows; its tp and pp peers vote with
    # it, its dp peers do not (dp is not a model-parallel axis)
    scaler = GradScaler(init_scale=4.0)
    state = scaler.init()
    g = torch.ones(3) * (float("inf") if rank == 5 else 1.0)
    unscaled, overflow = scaler.unscale({"w": g}, state)
    out["scaler_overflow"] = np.array(bool(overflow))
    out["scaler_unscaled"] = _np(unscaled["w"])
    out["scaler_next"] = np.array(float(
        scaler.update(state, overflow).loss_scale))
    only_tp = GradScaler(model_parallel_axes=("tp",))
    out["scaler_tp_only"] = np.array(bool(
        only_tp.unscale({"w": g}, only_tp.init())[1]))

    # RNG: the model-parallel stream differs per tp rank, equal over dp
    trand.model_parallel_rng_seed(1234)
    tracker = trand.get_rng_tracker()
    with tracker.fork() as gen:
        out["rng_tp"] = _np(torch.rand(4, generator=gen))
    with tracker.fork("default") as gen:
        out["rng_default"] = _np(torch.rand(4, generator=gen))
    base = torch.Generator().manual_seed(7)
    keyed = trand.tp_rank_key(base)
    out["rng_key"] = _np(torch.rand(4, generator=keyed))
    out["rng_base_after"] = _np(torch.rand(2, generator=base))

    # average_losses_across_data_parallel_group over dp
    losses = [torch.tensor(float(rank)), torch.tensor(2.0 * rank)]
    out["avg_losses"] = _np(pu.average_losses_across_data_parallel_group(
        losses))
    # the params' L2 norm: this rank's shard, squares summed over tp, pp
    shard = {"w": _t(inp["l2_w"])[rank]}
    out["l2"] = _np(pu.calc_params_l2_norm(shard))

    # the embedding all-reduce over pp (first and last stage)
    eg = _t(inp["emb_grad"])[rank]
    out["emb_allreduce"] = _np(p2p.embedding_allreduce(eg))

    # virtual pipeline and split-rank bookkeeping
    ps.destroy_model_parallel()
    out["dp_after_destroy"] = np.array(B.get_world_size("dp"))
    ps.initialize_model_parallel(2, 2, 2, pipeline_model_parallel_split_rank_=1)
    out["virtual"] = np.array([
        ps.get_virtual_pipeline_model_parallel_world_size(),
        ps.get_virtual_pipeline_model_parallel_rank(),
        ps.is_pipeline_first_stage(), ps.is_pipeline_last_stage(),
        ps.get_pipeline_model_parallel_split_rank(),
        ps.is_pipeline_stage_before_split(),
        ps.is_pipeline_stage_after_split(),
        ps.is_pipeline_stage_at_split()])
    ps.set_virtual_pipeline_model_parallel_rank(1)
    out["virtual_1"] = np.array([ps.is_pipeline_first_stage(),
                                 ps.is_pipeline_last_stage(),
                                 ps.is_pipeline_first_stage(True)])
    ps.set_tensor_model_parallel_rank(1)
    ps.set_pipeline_model_parallel_world_size(4)
    out["overrides"] = np.array([ps.get_tensor_model_parallel_rank(),
                                 ps.get_pipeline_model_parallel_world_size()])
    ps.destroy_model_parallel()
    return out


# ---------------------------------------------------------- tensor parallel

def _grads_of(loss, leaves):
    import torch

    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


def suite_megatron_tp(rank, n, inp, directory):
    """On 4 ranks: every mapping region at tp 4 (forward and VJP), then
    at tp 2 (dp 2) the per-shard layers, the module forms, the
    vocab-parallel CE, the chunked CE's tp path and llama's loss with
    tp (sequence parallelism on and off)."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.functional.chunked_ce import (
        chunked_lm_cross_entropy,
    )
    from apex_tpu_torch.transformer.tensor_parallel import layers as L
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
        vocab_parallel_cross_entropy,
    )
    from apex_tpu_torch.examples import llama_train as ex

    out = {}
    ps.initialize_model_parallel(4, 1)
    r = ps.get_tensor_model_parallel_rank()
    for name, (fn, x_rep, ct_rep, kw) in MAPPING_CASES.items():
        x = _t(inp[f"map_{name}_x"][r]).requires_grad_()
        y = getattr(mappings, fn)(x, **kw)
        y.backward(_t(inp[f"map_{name}_ct"][r]))
        out[f"map_{name}_y"], out[f"map_{name}_g"] = _np(y), _np(x.grad)
    ps.destroy_model_parallel()

    ps.initialize_model_parallel(2, 1)
    r = ps.get_tensor_model_parallel_rank()
    h = 8  # the column width a rank holds: 16 / tp

    # column -> gelu -> row (the reference's tp_linear test) with x live
    x = _t(inp["mlp_x"]).requires_grad_()
    k1 = _t(inp["mlp_k1"])[:, r * h:(r + 1) * h].clone().requires_grad_()
    k2 = _t(inp["mlp_k2"])[r * h:(r + 1) * h].clone().requires_grad_()
    hid = torch.nn.functional.gelu(
        L.column_parallel_linear(x, k1, gather_output=False),
        approximate="tanh")
    y = L.row_parallel_linear(hid, k2, input_is_parallel=True)
    loss = torch.mean(y ** 2)
    out["mlp_loss"] = _np(loss)
    out["mlp_gx"], out["mlp_gk1"], out["mlp_gk2"] = map(
        _np, _grads_of(loss, [x, k1, k2]))
    # gather_output and the bias; row with input_is_parallel=False
    b1 = _t(inp["mlp_b1"])[r * h:(r + 1) * h]
    out["col_gathered"] = _np(L.column_parallel_linear(
        x.detach(), k1.detach(), b1, gather_output=True))
    out["row_scatter_in"] = _np(L.row_parallel_linear(
        _t(inp["row_x"]), k2.detach(), _t(inp["row_b"]),
        input_is_parallel=False))
    # sequence parallel: gather in, reduce-scatter out
    xs = _t(inp["sp_x"])[:, r * 2:(r + 1) * 2]  # [b, s / tp, in]
    ys = L.row_parallel_linear(
        L.column_parallel_linear(xs, k1.detach(), gather_output=False,
                                 sequence_parallel_enabled=True, seq_dim=1),
        k2.detach(), sequence_parallel_enabled=True, seq_dim=1)
    out["sp_y"] = _np(ys)
    # the fp32-wgrad product
    xw = _t(inp["wg_x"]).to(torch.bfloat16).requires_grad_()
    w32 = _t(inp["wg_w"])[:, r * 4:(r + 1) * 4].clone().requires_grad_()
    yw = L.linear_with_grad_accumulation_and_async_allreduce(
        xw, w32, gradient_accumulation_fusion=True)
    gxw, gw = _grads_of(torch.sum(yw.float() * _t(inp["wg_ct"])[:, r * 4:
                                                              (r + 1) * 4]),
                        [xw, w32])
    out["wg_y"] = _np(yw.float())
    out["wg_gx"], out["wg_gw"] = _np(gxw.float()), _np(gw)
    out["wg_dtypes"] = np.array([str(yw.dtype), str(gxw.dtype),
                                 str(gw.dtype)])
    # vocab-parallel embedding, forward and table grad
    table = _t(inp["emb_table"])[r * 6:(r + 1) * 6].clone().requires_grad_()
    emb = L.vocab_parallel_embedding(_t(inp["emb_ids"]).long(), table)
    (gt,) = _grads_of(torch.sum(emb * _t(inp["emb_ct"])), [table])
    out["emb_y"], out["emb_gt"] = _np(emb), _np(gt)

    # the module forms: shards of one full weight drawn on every rank
    gen = torch.Generator().manual_seed(11)
    col = L.ColumnParallelLinear(8, 16, gather_output=True,
                                 keep_master_weight_for_test=True,
                                 generator=gen, device="cpu")
    row = L.RowParallelLinear(16, 8, input_is_parallel=False,
                              keep_master_weight_for_test=True,
                              generator=torch.Generator().manual_seed(12),
                              device="cpu")
    emb_mod = L.VocabParallelEmbedding(
        12, 6, generator=torch.Generator().manual_seed(13), device="cpu")
    xm = _t(inp["mlp_x"])
    out["mod_col"] = _np(col(xm)[0])
    out["mod_col_ref"] = _np(xm @ col.master_weight)
    out["mod_row"] = _np(row(col(xm)[0])[0])
    out["mod_row_ref"] = _np((xm @ col.master_weight) @ row.master_weight)
    out["mod_emb"] = _np(emb_mod(_t(inp["emb_ids"]).long()))
    out["mod_emb_range"] = np.array([emb_mod.vocab_start_index,
                                     emb_mod.vocab_end_index])
    out["mod_specs"] = np.array([str(L.param_partition_specs(col)),
                                 str(L.param_partition_specs(row))])
    out["mod_dup"] = np.array([
        L.param_is_not_tensor_parallel_duplicate(col.weight),
        L.param_is_not_tensor_parallel_duplicate(row.bias)])
    out["mod_col_weight"] = _np(col.weight)

    # vocab-parallel cross entropy (and label smoothing)
    for ls in (0.0, 0.1):
        lg = _t(inp["ce_logits"])[..., r * 8:(r + 1) * 8].clone()
        lg.requires_grad_()
        loss = vocab_parallel_cross_entropy(lg, _t(inp["ce_target"]).long(),
                                            label_smoothing=ls)
        (g,) = _grads_of(torch.sum(loss * _t(inp["ce_ct"])), [lg])
        out[f"ce_{ls}_loss"], out[f"ce_{ls}_grad"] = _np(loss), _np(g)
    # the chunked CE's vocab-parallel path
    hid = _t(inp["cce_hidden"]).requires_grad_()
    w = _t(inp["cce_weight"])[:, r * 16:(r + 1) * 16].clone()
    w.requires_grad_()
    losses = chunked_lm_cross_entropy(hid, w, _t(inp["cce_labels"]).long(),
                                      4, tp_axis="tp")
    gh, gw = _grads_of(torch.sum(losses * _t(inp["cce_ct"])), [hid, w])
    out["cce_loss"], out["cce_gh"], out["cce_gw"] = (_np(losses), _np(gh),
                                                     _np(gw))

    # llama's loss on tp shards: sequence parallel off/on, full and
    # chunked lm head (and the MoE MLP, its experts whole on every tp
    # rank); the norm scales summed over tp under sp
    coords = {"pp": (0, 1), "dp": _coords()["dp"], "tp": _coords()["tp"],
              "ep": (0, 1)}
    batch = (_t(inp["llama_tokens"]).long(), _t(inp["llama_targets"]).long())
    for prefix, cfg, cases in (
            ("llama", llama.tiny(),
             [(sp, c) for sp in (False, True) for c in (None, 4)]),
            ("moe", llama.tiny(num_experts=4),
             [(False, None), (True, None)])):
        full = {k: (_t(v) if not isinstance(v, dict) else
                    {kk: _t(vv) for kk, vv in v.items()})
                for k, v in _unpack(inp, prefix + "_").items()}
        specs = llama.param_specs(cfg)
        shards = {k: ({kk: ex.shard(vv, specs[k][kk], coords)
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else ex.shard(v, specs[k], coords))
                  for k, v in full.items()}
        for sp, chunks in cases:
            out.update(_llama_tp_grads(llama, cfg, shards, batch, sp, chunks,
                                       f"{prefix}_{int(sp)}_{chunks or 0}"))
    # tp_axis=None on the full params: the single-device path, tp bound
    cfg = llama.tiny()
    full = _tree.map_leaves(lambda v: _t(v).requires_grad_(),
                            _unpack(inp, "llama_"))
    loss = llama.loss_fn(full, batch, cfg, remat=False, tp_axis=None)
    out["unbound_loss"] = _np(loss)
    for path, g in zip(_tree.paths(full), _grads_of(loss,
                                                    _tree.leaves(full))):
        out["unbound_g_" + path[-1]] = _np(g)
    out["llama_heads_error"] = np.array(_error(
        lambda: llama.loss_fn(shards, batch, llama.tiny(num_kv_heads=1),
                              remat=False)))
    # a ring of one (the cp group of one rank bound here) is the
    # diagonal block merged with nothing: the flash path's loss exactly
    # (``shards`` are the MoE config's, the loop's last)
    moe_cfg = llama.tiny(num_experts=4)
    out["llama_cp1_loss"] = _np(llama.loss_fn(shards, batch, moe_cfg,
                                              remat=False, cp_axis="cp"))
    out["llama_tp_loss"] = _np(llama.loss_fn(shards, batch, moe_cfg,
                                             remat=False, cp_axis=None))
    ps.destroy_model_parallel()
    return out


def _llama_tp_grads(llama, cfg, shards, batch, sp, chunks, tag):
    """``llama.loss_fn`` on this rank's shards with tp bound: the loss and
    each leaf's gradient, the norm scales summed over tp under sequence
    parallelism (the reference example's reduction)."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch.distributed import backend as B

    live = _tree.map_leaves(lambda v: v.clone().requires_grad_(), shards)
    loss = llama.loss_fn(live, batch, cfg, remat=False, vocab_chunks=chunks,
                         tp_axis="tp", sequence_parallel=sp)
    out = {f"{tag}_loss": _np(loss)}
    for path, g in zip(_tree.paths(live), _grads_of(loss,
                                                    _tree.leaves(live))):
        name = path[-1]
        if sp and name.endswith("norm"):
            g = B.all_reduce(g, B.ReduceOp.SUM, "tp")
        out[f"{tag}_g_{name}"] = _np(g)
    return out


def _unpack(inp, prefix):
    """The nested params ``{'layers': {...}, ...}`` of flat keys
    ``prefix + 'layers.wq'`` etc."""
    tree = {}
    for key, value in inp.items():
        if not key.startswith(prefix + "p."):
            continue
        path = key[len(prefix) + 2:].split(".")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


# ---------------------------------------------------------------- pipeline

def suite_megatron_pp(rank, n, inp, directory):
    """On 4 ranks (pp 4): the collective forward, 1F1B forward and
    backward (and forward only), the interleaved schedule with 2 chunks,
    its chained fallback, and the p2p forms."""
    import torch

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import p2p
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as S

    out = {}
    ps.initialize_model_parallel(1, 4)
    r = ps.get_pipeline_model_parallel_rank()

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(o, t):
        return torch.mean((o - t) ** 2)

    params = {"w": _t(inp["pp_w"]), "b": _t(inp["pp_b"])}
    local = {k: v[r] for k, v in params.items()}
    x, tgt = _t(inp["pp_x"]), _t(inp["pp_tgt"])
    with torch.no_grad():
        out["fwd"] = _np(S.pipelined_forward(stage_fn, local, x, remat=False))
    loss, grads = S.forward_backward_pipelining_without_interleaving(
        stage_fn, loss_fn, local, x, tgt)
    out["fb_loss"] = _np(loss)
    out["fb_gw"], out["fb_gb"] = _np(grads["w"]), _np(grads["b"])
    loss_nr, grads_nr = S.forward_backward_pipelining_without_interleaving(
        stage_fn, loss_fn, local, x, tgt, remat=False)
    out["fb_noremat_gw"] = _np(grads_nr["w"])
    floss, fgrads = S.forward_backward_pipelining_without_interleaving(
        stage_fn, loss_fn, local, x, tgt, forward_only=True)
    out["fo_loss"], out["fo_none"] = _np(floss), np.array(fgrads is None)

    # interleaved: V = 2 chunks of the 8-stage model, rank r owns stages
    # r and r + 4
    chunks = {k: torch.stack([v[r], v[r + 4]])
              for k, v in {"w": _t(inp["il_w"]), "b": _t(inp["il_b"])}.items()}
    fbi = S.get_forward_backward_func(2, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        iloss, igrads = fbi(stage_fn, loss_fn, chunks, x, tgt)
    out["il_loss"] = _np(iloss)
    out["il_gw"], out["il_gb"] = _np(igrads["w"]), _np(igrads["b"])
    # M = 3 is not a multiple of P = 4: chained GPipe, with a warning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        closs, cgrads = fbi(stage_fn, loss_fn, chunks, x[:3], tgt[:3])
    out["chain_warned"] = np.array(any(
        issubclass(w.category, S.InterleavedFallbackWarning)
        for w in caught))
    out["chain_loss"], out["chain_gw"] = _np(closs), _np(cgrads["w"])
    out["strict_error"] = np.array(_error(
        lambda: S.pipelined_forward_interleaved(stage_fn, chunks, x[:3],
                                                strict=True)))
    out["fb_func"] = np.array([
        S.get_forward_backward_func(None, 4).__name__,
        S.get_forward_backward_func(2, 4).__name__,
        S.get_forward_backward_func(None, 1).__name__])

    # p2p: every form on this rank's tensor
    v = _t(inp["p2p_x"])[r]
    out["p2p_fwd"] = _np(p2p.send_forward_recv_forward(v))
    out["p2p_bwd"] = _np(p2p.send_backward_recv_backward(v))
    out["p2p_cyc"] = _np(p2p._shift_cyclic(v, +1))
    out["p2p_cyc_back"] = _np(p2p._shift_cyclic(v, -2))
    for name in ("send_forward", "recv_forward", "send_backward",
                 "recv_backward"):
        out[f"p2p_{name}"] = _np(getattr(p2p, name)(v))
    for name in ("send_forward_recv_backward", "send_backward_recv_forward",
                 "send_forward_backward_recv_forward_backward"):
        a, b = getattr(p2p, name)(v, v * 10)
        out[f"p2p_{name}"] = np.stack([_np(a), _np(b)])
    # the shift's gradient is the opposite shift
    vg = v.clone().requires_grad_()
    y = p2p._shift(vg, +1)
    y.backward(_t(inp["p2p_ct"])[r])
    out["p2p_grad"] = _np(vg.grad)
    ps.destroy_model_parallel()
    return out


# --------------------------------------------------------------- 3-D step

STEP_CASES = [(True, False), (False, False), (True, True), (False, True)]


def _moments(state, params, flat):
    """``(m, v)`` of a fused_adam state as trees like ``params`` (a flat
    state's slabs unpacked by the port's own layout)."""
    from apex_tpu_torch.ops import flat as _flat

    if not flat:
        return state.mu, state.nu
    meta = _flat.tree_meta(params)
    return (_flat.unflatten_tree(state.mu, meta),
            _flat.unflatten_tree(state.nu, meta))


def suite_megatron_step(rank, n, inp, directory):
    """The example's 3-D step on 8 ranks (pp 2 x dp 2 x tp 2), sequence
    parallelism on and off, fused_adam tree and flat: before each step
    the shards, then the step's loss and gradient shards, and after it
    the Adam moments; the shards after the last step."""
    import torch

    from apex_tpu_torch.examples import llama_train as ex
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer import parallel_state as ps

    out = {}
    ps.initialize_model_parallel(2, 2)
    cfg = ex.tiny_config(2, 2, 2, int(inp["seq"]))
    full = _unpack(inp, "")
    full = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else _t(v)) for k, v in full.items()}
    M, mb, s = (int(inp[k]) for k in ("M", "mb", "seq"))
    for sp, flat in STEP_CASES:
        tag = f"{int(sp)}{int(flat)}"
        stage, io = ex.shard_params(full, cfg)
        step = ex.Megatron3D(cfg, fused_adam(lr=float(inp["lr"]), flat=flat),
                             M, mb, s, sequence_parallel=sp)
        params = {"stage": stage, "io": io}
        opt_state = step.tx.init(params)
        for it in range(inp["tokens"].shape[0]):
            for k, p in {**stage, **io}.items():
                out[f"{tag}_p{it}_{k}"] = _np(p)
            tokens = step.local_batch(_t(inp["tokens"][it]).long())
            targets = torch.roll(tokens, -1, dims=-1)
            loss, g_stage, g_io = step.grads(stage, io, tokens, targets)
            opt_state = step.apply(stage, io, opt_state, g_stage, g_io)
            out[f"{tag}_loss{it}"] = _np(loss)
            for k, g in {**g_stage, **g_io}.items():
                out[f"{tag}_g{it}_{k}"] = _np(g)
            m, v = _moments(opt_state, params, flat)
            for part, tree in (("m", m), ("v", v)):
                for k, x in {**tree["stage"], **tree["io"]}.items():
                    out[f"{tag}_{part}{it}_{k}"] = _np(x)
        for k, p in {**stage, **io}.items():
            out[f"{tag}_p{inp['tokens'].shape[0]}_{k}"] = _np(p)
    ps.destroy_model_parallel()
    return out


def suite_megatron_cuda(rank, n, inp, directory):
    """Two ranks sharing the GPU over gloo: whether gloo sends a CUDA
    tensor as it is (on a throwaway group: rank 0 sends, rank 1 posts a
    CPU buffer, and rank 0 then closes the group, so a send that fails
    without a word cannot leave rank 1 waiting), and the port's pipeline
    shift of CUDA tensors (staged through pinned host memory) with its
    backward."""
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import p2p

    out = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    probe = dist.new_group([0, 1], backend="gloo")
    if rank == 0:
        out["send_cuda_error"] = np.array(_error(lambda: dist.send(
            torch.arange(4.0, device=dev), 1, group=probe)))
        dist.destroy_process_group(probe)
    else:
        buf = torch.full((4,), -1.0)
        out["recv_error"] = np.array(_error(lambda: dist.recv(
            buf, 0, group=probe)))
        out["recv_data"] = _np(buf)
        dist.destroy_process_group(probe)
    dist.barrier()
    ps.initialize_model_parallel(1, 2)
    v = torch.full((3,), float(rank + 1), device=dev, requires_grad=True)
    y = p2p._shift(v, +1)
    y.backward(torch.full((3,), 10.0 * (rank + 1), device=dev))
    out["shift"], out["shift_grad"] = _np(y), _np(v.grad)
    out["shift_device"] = np.array(str(y.device))
    ps.destroy_model_parallel()
    return out


SUITES = {"megatron_state": suite_megatron_state,
          "megatron_cuda": suite_megatron_cuda,
          "megatron_tp": suite_megatron_tp,
          "megatron_pp": suite_megatron_pp,
          "megatron_step": suite_megatron_step}
