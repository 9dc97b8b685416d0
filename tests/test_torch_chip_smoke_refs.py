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
