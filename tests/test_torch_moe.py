"""Parity of the port's MoE layer (apex_tpu_torch.transformer.moe) with
the JAX package's (apex_tpu.transformer.moe), single-device, fp32, on the
CPU: router_gates (combine, dispatch, aux loss, stats) for top-1 and
top-2, with and without capacity drops and with the z-loss on; moe_mlp's
output and gradients; the reference's own invariants; ep_axis refused.

Routing is a discrete choice: each comparison first checks that the
inputs' top-k margin (the smallest gap between the k-th and (k+1)-th
largest probability of any token, and between consecutive chosen ones)
is far above fp32 rounding, so a flipped route, an O(1) error, can only
come from a fault and never from summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import moe as jax_moe
from apex_tpu_torch.transformer import moe

#: combine and aux: fp32 softmax and products of the same values, summed
#: in another order
RTOL, ATOL = 1e-5, 1e-7
#: the smallest top-k margin the inputs must have: the probabilities are
#: at most 1 and both sides round them within a few fp32 ulps (~1e-7), so
#: 1e-5 leaves two orders of magnitude
MIN_MARGIN = 1e-5


def _cfg(**over):
    kw = dict(hidden_size=16, ffn_hidden_size=32, num_experts=8, top_k=2,
              capacity_factor=1.5)
    kw.update(over)
    return kw


def _margin(logits: np.ndarray, k: int) -> float:
    """Smallest gap between consecutive sorted probabilities among each
    token's top k + 1."""
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def _logits(seed: int, t: int, e: int, k: int) -> np.ndarray:
    logits = (3 * np.random.default_rng(seed).standard_normal(
        (t, e))).astype(np.float32)
    assert _margin(logits, k) > MIN_MARGIN
    return logits


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_router_gates_match_jax(top_k, capacity_factor, z_loss):
    """combine, dispatch, aux and the stats against the reference's
    router_gates; capacity 0.5 drops tokens, 8.0 drops none."""
    kw = _cfg(top_k=top_k, capacity_factor=capacity_factor,
              z_loss_coef=z_loss)
    logits = _logits(top_k + 10 * int(capacity_factor), 48, 8, top_k)
    ref = jax_moe.router_gates(jnp.asarray(logits), jax_moe.MoEConfig(**kw),
                               with_stats=True)
    got = moe.router_gates(torch.from_numpy(logits), moe.MoEConfig(**kw),
                           with_stats=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=RTOL)
    for key in ("dropped_frac", "balance_loss", "z_loss"):
        np.testing.assert_allclose(float(got[3][key]), float(ref[3][key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    dropped = float(got[3]["dropped_frac"])
    assert (dropped > 0) == (capacity_factor < 1.0)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.75])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_forward_and_grads_match_jax(top_k, capacity_factor):
    """moe_mlp's y and aux, and the gradients of sum(y * g) + aux with
    respect to the router, wi, wo and x, against jax.grad."""
    kw = _cfg(top_k=top_k, capacity_factor=capacity_factor)
    jcfg = jax_moe.MoEConfig(**kw)
    jparams = jax_moe.init_moe_params(jax.random.PRNGKey(top_k), jcfg)
    rng = np.random.default_rng(top_k)
    x = rng.standard_normal((4, 12, 16)).astype(np.float32)
    g = rng.standard_normal((4, 12, 16)).astype(np.float32)
    logits = x.reshape(-1, 16) @ np.asarray(jparams["router"])
    assert _margin(logits, top_k) > MIN_MARGIN

    def jloss(p, x):
        y, aux = jax_moe.moe_mlp(p, x, jcfg, ep_axis=None)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (ref_y, ref_aux)), ref_grads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))
    params = {k: torch.from_numpy(np.asarray(v)).requires_grad_()
              for k, v in jparams.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_mlp(params, xt, moe.MoEConfig(**kw))
    loss = torch.sum(y * torch.from_numpy(g)) + aux
    grads = torch.autograd.grad(loss, [params["router"], params["wi"],
                                       params["wo"], xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=RTOL)
    for name, got, ref in zip(("router", "wi", "wo"), grads,
                              (ref_grads[0]["router"], ref_grads[0]["wi"],
                               ref_grads[0]["wo"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(ref_grads[1]),
                               rtol=1e-4, atol=1e-5)


def test_top1_routes_to_argmax_with_raw_gate():
    """Switch: each token's one slot is its argmax expert, gated by the
    raw top probability (a renormalised top-1 gate would be 1)."""
    cfg = moe.MoEConfig(**_cfg(top_k=1, capacity_factor=8.0))
    logits = torch.from_numpy(_logits(0, 32, 8, 1))
    combine, _, _ = moe.router_gates(logits, cfg)
    chosen = torch.argmax(combine.sum(-1), dim=-1)
    assert torch.equal(chosen, torch.argmax(logits, dim=-1))
    torch.testing.assert_close(combine.sum((-2, -1)),
                               torch.softmax(logits, -1).amax(-1))


def test_top1_router_gets_task_gradient():
    cfg = moe.MoEConfig(**_cfg(top_k=1, capacity_factor=8.0,
                               aux_loss_coef=0.0))
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn(32, 16, generator=torch.Generator().manual_seed(1))
    y, _ = moe.moe_mlp(params, x, cfg)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), params["router"])
    assert float(g.abs().max()) > 0


def test_capacity_limit():
    """Every token prefers expert 0: C of them fit, the rest drop with a
    zero combine weight."""
    cfg = moe.MoEConfig(**_cfg(top_k=1, capacity_factor=0.25))
    logits = torch.zeros(32, 8)
    logits[:, 0] = 5.0
    combine, dispatch, _ = moe.router_gates(logits, cfg)
    cap = combine.shape[-1]
    per_expert = dispatch.sum((0, 2))
    assert int(per_expert[0]) == cap and int(per_expert[1:].sum()) == 0
    assert (combine.sum((1, 2))[cap:] == 0).all()


def test_slots_unique_and_aux_positive():
    cfg = moe.MoEConfig(**_cfg())
    combine, dispatch, aux = moe.router_gates(
        torch.from_numpy(_logits(1, 64, 8, 2)), cfg)
    assert int(dispatch.sum(0).max()) <= 1
    assert torch.isfinite(aux) and float(aux) > 0
    assert combine.dtype == torch.float32 and dispatch.dtype == torch.bool


def test_full_capacity_equals_dense_mixture():
    """No drops and top_k == E: the probability-weighted mixture of all
    experts."""
    cfg = moe.MoEConfig(**_cfg(num_experts=4, top_k=4, capacity_factor=8.0))
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    x = torch.randn(12, 16, generator=torch.Generator().manual_seed(1))
    y, _ = moe.moe_mlp(params, x, cfg)
    probs = torch.softmax(x @ params["router"], dim=-1)
    h = torch.nn.functional.gelu(torch.einsum("th,ehf->tef", x,
                                              params["wi"]),
                                 approximate="tanh")
    dense = torch.einsum("tef,efh->teh", h, params["wo"])
    want = torch.einsum("te,teh->th", probs, dense)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


def test_init_moe_params_layout():
    cfg = moe.MoEConfig(**_cfg())
    p = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.bfloat16, device="cpu")
    assert p["router"].shape == (16, 8)
    assert p["wi"].shape == (8, 16, 32) and p["wo"].shape == (8, 32, 16)
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    lim = (6.0 / (16 + 32)) ** 0.5
    assert float(p["wi"].float().abs().max()) <= lim


def test_expert_parallel_axis_raises():
    """An ``ep_axis`` with no group bound to it is the reference's
    unbound-axis path: every expert runs here, the same numbers as
    ``ep_axis=None`` (the bound path, the all-to-all dispatch, is held
    on gloo ranks by ``tests/test_torch_expert_parallel.py``)."""
    cfg = moe.MoEConfig(**_cfg())
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    y, aux = moe.moe_mlp(params, x, cfg, ep_axis="ep")
    y0, aux0 = moe.moe_mlp(params, x, cfg, ep_axis=None)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert moe.moe_param_specs(cfg) == {"router": (),
                                        "wi": ("ep", None, None),
                                        "wo": ("ep", None, None)}


def test_init_moe_params_needs_a_gpu_by_default(monkeypatch):
    """An entry point: with no ``device`` it places the params on the
    GPU, and raises where there is none."""
    cfg = moe.MoEConfig(**_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init_moe_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("elsewhere", [False, True])
def test_router_jitter_draws_on_the_logits_device(monkeypatch, elsewhere):
    """The jitter's uniforms are drawn on the logits' device: from
    ``router_key`` itself when it lies there, else from a generator
    there seeded with one draw of ``router_key`` (forced here by making
    the CPU generator count as lying elsewhere)."""
    from apex_tpu_torch import _device

    cfg = moe.MoEConfig(**_cfg(router_jitter=0.1))
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    x = torch.randn(12, 16, generator=torch.Generator().manual_seed(1))
    if elsewhere:
        monkeypatch.setattr(_device, "_same", lambda a, b: False)
    got = moe.moe_mlp(params, x, cfg,
                      router_key=torch.Generator().manual_seed(9))[0]
    key = torch.Generator().manual_seed(9)
    if elsewhere:
        key = torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 63 - 1, (), generator=key)))
    u = torch.rand((12, 8), generator=key)
    logits = (x @ params["router"]) * (u * 0.2 + 0.9)
    combine, dispatch, _ = moe.router_gates(logits, cfg)
    y = torch.nn.functional.gelu(torch.einsum(
        "tec,th,ehf->ecf", dispatch.float(), x, params["wi"]),
        approximate="tanh")
    want = torch.einsum("tec,ecf,efh->th", combine, y, params["wo"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.equal(got, moe.moe_mlp(params, x, cfg)[0])
