"""The fp32 references of ``chip_smoke.py``'s GPT-2 and BERT gradient
checks write the attention and the MLP out with plain torch ops, apart
from the model code they check. Here, on the CPU at tiny() in fp32, each
must give the model's loss and gradients (both sides take the kernels'
plain versions on the CPU and differ only in the order of their sums):
the loss to LOSS_RTOL = 1e-5, every gradient leaf to GRAD_ATOL/GRAD_RTOL
= 1e-4. The MoE generation check's routing pin is held here too.
"""

import importlib.util
import pathlib

import pytest
import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.models import bert, gpt2, llama

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
B, S = 2, 16


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(family, smoke):
    gen = torch.Generator().manual_seed(0)
    if family == "gpt2":
        cfg = gpt2.tiny()
        params = gpt2.init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        batch = (tokens, torch.roll(tokens, -1, dims=-1))
        return (params,
                lambda t: gpt2.loss_fn(t, batch, cfg, remat=True,
                                       vocab_chunks=4),
                lambda t: smoke.gpt2_plain_loss(t, batch, cfg))
    cfg = bert.tiny()
    params = bert.init_params(gen, cfg, device="cpu")
    targets = torch.randint(4, cfg.vocab_size, (B, S), generator=gen)
    pad = torch.zeros(B, S, dtype=torch.bool)
    pad[1, 11:] = True
    mlm = (torch.rand(B, S, generator=gen) < 0.3) & ~pad
    mlm[0, 0] = True
    inputs = torch.where(mlm, 3, torch.where(pad, 0, targets))
    batch = (inputs, targets, mlm.float())
    if family == "bert_unpadded":  # pad_mask=None: the unmasked softmax
        pad = None
    return (params,
            lambda t: bert.loss_fn(t, batch, cfg, pad_mask=pad, remat=True),
            lambda t: smoke.bert_plain_loss(t, batch, cfg, pad))


def _loss_and_grads(loss_of, params):
    live = _tree.map_leaves(lambda t: t.detach().requires_grad_(), params)
    loss = loss_of(live)
    return loss.detach(), torch.autograd.grad(loss, _tree.leaves(live))


@pytest.mark.parametrize("family", ["gpt2", "bert", "bert_unpadded"])
def test_reference_matches_the_model(family, smoke):
    params, model_loss, ref_loss = _case(family, smoke)
    loss, grads = _loss_and_grads(model_loss, params)
    ref, ref_grads = _loss_and_grads(ref_loss, params)
    torch.testing.assert_close(ref, loss, rtol=LOSS_RTOL, atol=0)
    for path, g, r in zip(_tree.paths(params), grads, ref_grads):
        torch.testing.assert_close(r, g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda m: f"{path}: {m}")



@pytest.mark.parametrize("k", [2, 1])
def test_moe_generate_pin_follows_the_generate_run(k, smoke):
    """``chip_smoke.py``'s moe_generate pin, on ``tiny(num_experts=4)``
    in fp32 at capacity factor E/k: ``generate_routes`` gives the tokens
    of ``greedy_generate`` and, a layer each, the experts that run took
    at every position (at fp32 the forward's own top-k: these inputs'
    top-k margin is checked above 1e-4 first); ``pinned_forward`` to
    those routes gives the unpinned forward's logits within 1e-5 (the
    same experts and gates, sums in another order); pinned to other
    routes it does not."""
    from apex_tpu_torch.models import generate
    from apex_tpu_torch.transformer import moe

    cfg = llama.tiny(num_layers=2, num_experts=4, moe_top_k=k,
                     moe_capacity_factor=4.0 / k)
    params = llama.init_params(torch.Generator().manual_seed(5), cfg,
                               device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(6))
    out, routes = smoke.generate_routes(generate, params, prompts, cfg, 4,
                                         device="cpu")
    assert torch.equal(out, generate.greedy_generate(params, prompts, cfg,
                                                     4, device="cpu"))
    assert [r.shape for r in routes] == [(2, 9, k)] * cfg.num_layers
    seq = out[:, :-1]
    own = []
    real = smoke.record_router(moe, own, cfg.num_layers)
    try:
        ref = llama.forward(params, seq, cfg)
    finally:
        moe.router_gates = real
    for logits, r in zip(own, routes):
        top = torch.topk(logits, min(k + 1, 4), dim=-1).values
        assert float((top[:, k - 1] - top[:, k]).min()) > 1e-4
        assert torch.equal(torch.topk(logits, k, dim=-1).indices,
                           r.reshape(-1, k))
    got = smoke.pinned_forward(moe, llama, params, seq, cfg, routes)
    assert moe.router_gates is real
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    shifted = [(r + 1) % cfg.num_experts for r in routes]
    moved = smoke.pinned_forward(moe, llama, params, seq, cfg, shifted)
    assert float((moved - ref).abs().max()) > 1e-2
    tf = smoke.generated_gap(got, smoke.pinned_forward(
        moe, llama, params, seq[:, :6], cfg, routes), out, 6)
    assert tf["worst_gap"] == 0.0 and tf["spread"] < 1e-5


def test_chip_smoke_defines_each_name_once():
    """A second top-level ``def`` of a name would silently replace the
    first for every phase that calls it."""
    import ast
    import collections

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter(
        n.name for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    assert [n for n, c in names.items() if c > 1] == []


@pytest.mark.parametrize("name", ["mlp_none", "mlp_relu", "mlp_sigmoid",
                                  "fused_dense_gelu_dense"])
def test_mlp_fused_dense_reference_matches_the_modules(name, smoke):
    """mlp_fused_dense's fp32 reference (``mlp_plain32``) gives the port's
    MLP and fused dense layers in fp32, and its pinned ReLU signs
    (``relu_masks``) the signs the port's chain computes: pinned, the
    reference is unchanged."""
    from apex_tpu_torch import fused_dense, mlp

    gen = torch.Generator().manual_seed(1)
    if name.startswith("mlp_"):
        m = mlp.MLP([24, 32, 16, 1], activation=name[4:], device="cpu")
        inputs = [torch.randn(8, 24, generator=gen)] + m.flat()
        fn = lambda *a: mlp.mlp_function(True, name[4:], *a)  # noqa: E731
    else:
        p = fused_dense.FusedDenseGeluDense(16, 32, 8, device="cpu").params
        inputs = [torch.randn(2, 3, 16, generator=gen), p["weight1"],
                  p["bias1"], p["weight2"], p["bias2"]]
        fn = fused_dense.fused_dense_gelu_dense_function
    r = torch.randn(fn(*inputs).shape, generator=gen)
    y, grads = smoke.fwd_bwd(fn, inputs, r)
    y32, g32 = smoke.fwd_bwd(lambda *a: smoke.mlp_plain32(name, a), inputs,
                             r)
    torch.testing.assert_close(y, y32, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for g, want in zip(grads, g32):
        torch.testing.assert_close(g, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if name == "mlp_relu":
        masks = smoke.relu_masks(inputs)
        pinned = smoke.fwd_bwd(lambda *a: smoke.mlp_plain32(name, a, masks),
                               inputs, r)
        torch.testing.assert_close(pinned[0], y32, rtol=0, atol=0)


def test_megatron_o4_launches_follow_megatron_training(smoke):
    """megatron_o4's launches: megatron_training's with the last stage's
    final norm once (the folded lm head) and its three casts, the fill at
    a process's first cast."""
    cfg = llama.llama3_8b(num_layers=smoke.MEGO4_LAYERS)
    first = smoke.mego4_want(cfg, False, True)
    assert first == smoke.megatron_want(cfg, False)
    last = smoke.mego4_want(cfg, True, True)
    base = smoke.megatron_want(cfg, True)
    assert last["rms_norm_fwd"] == base["rms_norm_fwd"] - smoke.MEG_M + 1
    assert last["rms_norm_bwd"] == base["rms_norm_bwd"] - smoke.MEG_M + 1
    assert (last["fp8_cast"], last["fp8_cast_col"],
            last["fp8_cast_fill"]) == (2, 1, 1)
    assert smoke.mego4_want(cfg, True, False)["fp8_cast_fill"] == 0


def test_mlstm_model_and_loss_match_the_reference(smoke):
    """rnn_mlstm's model and loss (``mlstm_lm``, ``mlstm_lm_loss``), at a
    tiny width on the CPU: the same params through the JAX package's
    mLSTM, weight norm and a cross entropy give the same loss (1e-5) and
    gradients (1e-4 relative L2 per leaf)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from apex_tpu import reparameterization as jrp
    from apex_tpu import rnn as jrnn

    model, params = smoke.mlstm_lm("cpu", vocab=16, embed=4, hidden=8)
    assert set(params["rnn"]) == {
        "w_ih_g", "w_ih_v", "w_hh_g", "w_hh_v", "w_mih_g", "w_mih_v",
        "w_mhh_g", "w_mhh_v", "b_ih", "b_hh"}
    tokens = torch.randint(0, 16, (3, 7), generator=torch.Generator()
                           .manual_seed(0))
    loss, grads = _loss_and_grads(
        lambda t: smoke.mlstm_lm_loss(t, model, tokens), params)
    jm = jrnn.mLSTM(4, 8)
    tok = jnp.asarray(tokens.numpy())

    def jloss(p):
        x = jnp.swapaxes(p["embed"][tok[:, :-1]], 0, 1)
        out, _ = jm(x, params=[jrp.compute_weights(p["rnn"])])
        logits = out @ p["dec_w"].T + p["dec_b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        tgt = jnp.swapaxes(tok[:, 1:], 0, 1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for path, g, r in zip(_tree.paths(params), grads,
                          jax.tree_util.tree_leaves(jg)):
        r = np.asarray(r)
        assert np.linalg.norm(g.numpy() - r) <= 1e-4 * np.linalg.norm(r), \
            path
    # the bf16 cell step and the fp32 one agree at this width too
    x = params["embed"][tokens[:, 0]]
    carry = (torch.randn(3, 8), torch.randn(3, 8))
    cot = [torch.randn(3, 8), torch.randn(3, 8)]
    g32 = smoke.mlstm_cell_grads(params["rnn"], x, carry, cot,
                                 torch.float32)
    g16 = smoke.mlstm_cell_grads(params["rnn"], x, carry, cot,
                                 torch.bfloat16)
    cmp = smoke.leaf_compare(_tree.paths(params["rnn"]), g16, g32)
    assert cmp["worst_rel_l2"] <= smoke.GRAD_REL_L2


def test_mlstm_step_flops_count(smoke):
    """rnn_mlstm's FLOP count: forward 2 B (64 * 4096 + 4096^2 + 64 *
    16384 + 4096 * 16384 + 4096 * 256) a timestep, times 3, times 256."""
    smoke_flops = smoke.mlstm_step_flops()
    per_t = 2 * 128 * (64 * 4096 + 4096 ** 2 + 64 * 16384 + 4096 * 16384
                       + 4096 * 256)
    assert smoke_flops == 3 * per_t * 256


def test_larc_reference_matches_larc_scale(smoke):
    """The resnet50_training LARC check's float64 formula
    (``larc_reference``) against the port's ``larc_scale``: clipped and
    not, with and without decay, zero norms unscaled."""
    from apex_tpu_torch.parallel.larc import larc_scale

    gen = torch.Generator().manual_seed(3)
    for scale_g in (1e-3, 1.0, 100.0):
        g = scale_g * torch.randn(6, 5, generator=gen)
        p = torch.randn(6, 5, generator=gen)
        for clip in (True, False):
            for wd in (0.0, 1e-4):
                got = larc_scale(g, p, lr=0.1, trust_coefficient=0.02,
                                 clip=clip, eps=1e-8, weight_decay=wd)
                want = smoke.larc_reference(g, p, 0.1, clip=clip,
                                            weight_decay=wd)
                torch.testing.assert_close(got.double(), want, rtol=1e-6,
                                           atol=1e-12)
    zero = torch.zeros(4)
    g = torch.randn(4, generator=gen)
    torch.testing.assert_close(smoke.larc_reference(g, zero, 0.1,
                                                    weight_decay=0.0),
                               g.double())


def test_multi_tensor_check_runs_and_catches(smoke):
    """bert_optimizers' multi-tensor check at a small size on the CPU:
    it passes on honest ops and reports the planted inf."""
    gen = torch.Generator().manual_seed(4)
    grads = {"a": torch.randn(40, 3, generator=gen).bfloat16(),
             "b": torch.randn(17, generator=gen).bfloat16()}
    params = {"a": torch.randn(40, 3, generator=gen).bfloat16(),
              "b": torch.randn(17, generator=gen).bfloat16()}
    out = smoke.check_multi_tensor(grads, params)
    assert all(out["inf_reported"].values())
    assert max(out["max_rel_err"].values()) <= smoke.MT_REL


@pytest.mark.parametrize("name", ["mp_lamb", "novograd", "adagrad"])
def test_bert_optimizer_state_check(name, smoke):
    """bert_optimizers' check of one step against the CPU transform, and
    MP-LAMB's ``p + (round(master) - p)`` count, on a tiny tree."""
    from apex_tpu_torch import optimizers as opts

    _, cls, kw = next(o for o in smoke.BERT_OPTIMIZERS if o[0] == name)
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(64, 8, generator=gen).bfloat16(),
              "b": torch.randn(8, generator=gen).bfloat16()}
    opt = getattr(opts, cls)(params, **kw)
    for s in range(2):
        grads = {k: torch.randn(v.shape, generator=gen).bfloat16()
                 for k, v in params.items()}
        host = (smoke.host_copy(grads), smoke.host_copy(opt.params),
                smoke.host_copy(opt.state))
        p_old = _tree.map_leaves(torch.clone, opt.params)
        opt.step(grads)
    cmp, mp = smoke.bert_opt_state_check(name, opt, host, p_old)
    assert cmp["worst_rel_l2"] == 0.0
    if name == "mp_lamb":
        assert mp["bf16_params_follow_reference"]
        assert 0 <= mp["bf16_differ_from_round_master"] <= mp[
            "bf16_elements"]
    else:
        assert mp == {}


def test_suites_run_each_multi_rank_path(smoke):
    """Every phase that launches ranks but megatron_o4 (its own launch,
    and its resume in fresh processes) runs in one of the suites'
    launches (the one-rank NCCL paths, the 2-rank and the 4-rank gloo
    paths), each path once, with a rank function."""
    paths = [p for _, _, ps in smoke.SUITES.values() for p in ps]
    assert len(paths) == len(set(paths)) == 17
    assert "megatron_o4" not in paths
    own = {"megatron_o4", "megatron_o4_resume"}
    assert set(smoke.LAUNCH_TIMEOUT) == set(smoke.SUITES) | own
    for phase in own:
        assert callable(smoke.rank_fn(phase, pathlib.Path(".")))
    assert smoke.SUITES["nccl_suite"][2][-1] == "resnet50_ddp_nccl"
    for name, (nprocs, backend, ps) in smoke.SUITES.items():
        assert (nprocs, backend) == {"nccl_suite": (1, "nccl"),
                                     "gloo2_suite": (2, "gloo"),
                                     "gloo4_suite": (4, "gloo")}[name]
        for phase in ps + (name,):
            assert callable(smoke.rank_fn(phase, pathlib.Path(".")))


def test_trace_counters_cover_the_port_kernels(smoke):
    """Every kernel of ``ops/csrc`` that ``pyprof.parse.PORT_KERNELS``
    names has a row in ``TRACE_COUNTER``, each counter is a launch
    counter, and a kernel that serves two counters is told apart by its
    template argument: the profiled window's counts come from the
    parser's own naming rule."""
    from apex_tpu_torch.pyprof import parse

    kernels = {
        "tc": ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
               "flash_bwd_dkv_tc_kernel"),
        "(anonymous namespace)": (
            "flash_fwd_fp32_kernel", "flash_bwd_dq_fp32_kernel",
            "flash_bwd_dkv_fp32_kernel", "adam_kernel", "cast_scale_kernel",
            "cast_scale_t_kernel", "softmax_rows_kernel",
            "softmax_stats_kernel", "softmax_apply_kernel"),
        "row_norm": ("fwd_rows_kernel", "bwd_rows_kernel", "fwd_kernel",
                     "bwd_kernel", "column_sum_kernel")}
    for ns, idents in kernels.items():
        for ident in idents:
            name = f"void {ns}::{ident}<false, float, true>(float*)"
            assert parse.port_kernel(name) == (ident,
                                               ("false", "float", "true"))
            assert ident in smoke.TRACE_COUNTER
    assert set(smoke.TRACE_COUNTER) == {i for v in kernels.values()
                                        for i in v}
    assert set(smoke.TRACE_KERNELS) <= set(smoke.read_counts())
    cases = {
        "void row_norm::fwd_rows_kernel<false, __nv_bfloat16, "
        "__nv_bfloat16>(x)": "rms_norm_fwd",
        "void row_norm::fwd_kernel<true, float, float>(x)": "layer_norm_fwd",
        "void row_norm::bwd_rows_kernel<false, float, float>(x)":
            "rms_norm_bwd",
        "void row_norm::column_sum_kernel<float>(x)": None,
        "void tc::flash_bwd_dkv_tc_kernel<128, false>(tc::Params)":
            "flash_attention_bwd_dkv",
        "void (anonymous namespace)::softmax_rows_kernel<__nv_bfloat16, "
        "2048, false>(x)": "fused_softmax_masked",
        "void (anonymous namespace)::adam_kernel<float, true>(x)":
            "fused_adam",
        "void at::native::(anonymous namespace)::adam_kernel<float>(x)":
            None,
    }
    for name, counter in cases.items():
        assert smoke.trace_kernel(name) == counter, name


# ------------------------------------------- the contrib slice's references

def test_host_mask_counts_as_the_port_sorts(smoke):
    """contrib's ASP check holds the card's masks against
    ``host_mn_mask``, which counts; on the CPU it equals
    ``contrib.sparsity.mn_1d_mask`` (a stable sort), ties included."""
    from apex_tpu_torch.contrib.sparsity import mn_1d_mask

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 48, generator=gen)
    w[::3, :8] = 1.0  # whole groups tied
    w[1, 4:8] = torch.tensor([2.0, -2.0, 2.0, 0.5])
    assert torch.equal(smoke.host_mn_mask(w), mn_1d_mask(w))
    assert torch.equal(smoke.host_mn_mask(w.bfloat16().float()),
                       mn_1d_mask(w.bfloat16()))


def test_float64_transducer_reference_is_the_loss(smoke):
    """contrib's cut check: ``rnnt_loss64`` (cell by cell, float64)
    against the port's wavefront on the same logits, loss and dlogits."""
    from apex_tpu_torch.contrib.transducer import transducer_loss

    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(1, 12, 6, 9, generator=gen)
    targets = torch.randint(1, 9, (1, 5), generator=gen)
    x = logits.clone().requires_grad_()
    got = transducer_loss(x, targets, torch.tensor([10]), torch.tensor([4]))
    got.sum().backward()
    x64 = logits.double().requires_grad_()
    ref = smoke.rnnt_loss64(x64[0], targets[0], 10, 4)
    ref.backward()
    torch.testing.assert_close(got[0].double(), ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x.grad.double(), x64.grad, rtol=1e-5,
                               atol=1e-6)


def test_relu_decisions_pin_and_count(smoke):
    """The split-vs-whole checks pin ReLU decisions: recorded in call
    order, applied back, the differing decisions counted."""
    import torch.nn.functional as F

    x = torch.tensor([-1.0, 0.5, 2.0])
    rec = []
    with smoke.relu_decisions(record=rec):
        F.relu(x)
    assert F.relu is torch.nn.functional.relu
    flips = [0]
    with smoke.relu_decisions(pinned=[torch.tensor([True, False, True])],
                              flips=flips):
        y = F.relu(x)
    assert torch.equal(rec[0], torch.tensor([False, True, True]))
    assert torch.equal(y, torch.tensor([-1.0, 0.0, 2.0])) and flips == [2]


def test_bf16_ulps_counts_one_rounding(smoke):
    old = torch.tensor([1.0, 0.0012, 0.5]).bfloat16()
    step = torch.tensor([1e-3, -1e-3, 0.25])
    once = (old.float() + step).bfloat16()
    twice = old + step.bfloat16()
    assert smoke.bf16_ulps(once, twice, old) <= 1.0
    assert smoke.bf16_ulps(once, once, old) == 0.0


def test_hf_phase_config_is_llama3_8b(smoke):
    """hf_finetune_nccl's HF config converts to the port's llama3_8b."""
    from apex_tpu_torch.models import convert, llama

    for layers in (2, 32):
        cfg = convert.llama_config_from_hf(smoke.hf_llama3_8b(layers))
        assert cfg == llama.llama3_8b(num_layers=layers)
    want = smoke.hf_step_want(2)
    assert (want["flash_attention_fwd"], want["rms_norm_fwd"],
            want["rms_norm_bwd"]) == (4, 9, 5)
    assert smoke.hf_generate_want(2, 8)["rms_norm_fwd"] == 40
