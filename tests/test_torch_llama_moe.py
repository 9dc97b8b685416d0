"""Parity of the port's Mixtral-style MoE Llama (``num_experts > 0``)
with the JAX package's on ``tiny(num_experts=4)``, fp32, from the same
numpy params and batch: logits and the aux loss of ``forward_with_aux``,
the loss with its aux and every gradient leaf against ``jax.grad``, 3
``train_step``s with ``fused_adam(flat=True)`` against the JAX step, the
JAX tree loaded with no reshape, and top-1 (Switch) routing.

The JAX side runs its Pallas kernels in interpret mode; the port takes
the kernels' plain versions on the CPU. Every test first checks the
routing margin of each layer's router logits (recorded on the port's
side): at fp32 a flipped route would be an O(1) error, never a rounding
one. Tolerances are those of ``test_torch_training.py`` (fp32 sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import llama as jax_llama
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.transformer import moe
from test_torch_training import (
    GRAD_ATOL,
    GRAD_RTOL,
    STEP_RTOL,
    _assert_tree_close,
    _port_batch,
    _port_params,
)

LR = 1e-3
#: the smallest gap between consecutive sorted router probabilities among
#: a token's top k + 1: both sides round them within a few fp32 ulps
MIN_MARGIN = 1e-5


def _jax_kw():
    return dict(tp_axis=None, cp_axis=None, ep_axis=None, remat=False)


@pytest.fixture(scope="module", params=[2, 1], ids=["top2", "top1"])
def model(request):
    k = request.param
    jcfg = jax_llama.tiny(num_experts=4, moe_top_k=k)
    jparams = jax_llama.init_params(jax.random.PRNGKey(k), jcfg)
    tokens = np.random.default_rng(k).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    return (jcfg, jparams, port_llama.tiny(num_experts=4, moe_top_k=k),
            tokens, targets)


def _routing_margin(params, tokens, cfg) -> float:
    """The smallest top-k margin over every layer's router probabilities
    in a port forward of ``tokens``."""
    seen = []
    real = moe.router_gates

    def gates(logits, mcfg, with_stats=False):
        seen.append(logits.detach())
        return real(logits, mcfg, with_stats)

    moe.router_gates = gates
    try:
        port_llama.forward(params, tokens, cfg)
    finally:
        moe.router_gates = real
    assert len(seen) == cfg.num_layers
    worst = 1.0
    for logits in seen:
        top = torch.topk(torch.softmax(logits, -1), cfg.moe_top_k + 1,
                         dim=-1).values
        worst = min(worst, float((top[:, :-1] - top[:, 1:]).min()))
    return worst


def _value_and_grad(params, batch, cfg, **kw):
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = port_llama.loss_fn(live, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    return loss, _tree.unflatten(_tree.paths(params), list(grads))


def test_params_from_numpy_takes_the_moe_tree(model):
    """The JAX MoE tree (router [L, h, E], experts [L, E, ...]) converts
    leaf for leaf with no reshape, and init_params draws the same
    layout."""
    jcfg, jparams, cfg, _, _ = model
    params = _port_params(jparams)
    for path, ref in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == ref.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(ref))
    drawn = port_llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    assert _tree.paths(drawn) == _tree.paths(params)
    for a, b in zip(_tree.leaves(drawn), _tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert drawn["layers"]["wg"].shape == (2, 4, 64, 128)


def test_forward_with_aux_matches_jax(model):
    """Logits and the summed aux loss of forward_with_aux."""
    jcfg, jparams, cfg, tokens, _ = model
    params = _port_params(jparams)
    tok = torch.from_numpy(tokens).long()
    assert _routing_margin(params, tok, cfg) > MIN_MARGIN
    with pallas_config.force("interpret"):
        ref_logits, ref_aux = jax_llama.forward_with_aux(
            jparams, jnp.asarray(tokens), jcfg, **_jax_kw())
    with torch.no_grad():
        logits, aux = port_llama.forward_with_aux(params, tok, cfg,
                                                  remat=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert float(aux) > 0
    np.testing.assert_allclose(port_llama.forward(params, tok, cfg).numpy(),
                               logits.numpy(), rtol=0, atol=0)


def test_loss_and_grads_match_jax(model):
    """loss_fn (CE + aux) and every gradient leaf, router and experts
    included, against jax.value_and_grad."""
    jcfg, jparams, cfg, tokens, targets = model
    params = _port_params(jparams)
    with pallas_config.force("interpret"):
        ref_loss, ref_grads = jax.value_and_grad(jax_llama.loss_fn)(
            jparams, (jnp.asarray(tokens), jnp.asarray(targets)), jcfg,
            **_jax_kw())
    loss, grads = _value_and_grad(params, _port_batch(tokens, targets), cfg,
                                  remat=False)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _assert_tree_close(grads, ref_grads, GRAD_ATOL, GRAD_RTOL, "grad")


def test_three_train_steps_match_jax_step(model):
    """3 train_steps with fused_adam(flat=True) against value_and_grad ->
    fused_adam(flat=True, use_kernel=True) -> tree_map(add): losses,
    each param leaf's displacement and the flat m/v slabs."""
    jcfg, jparams, cfg, tokens, targets = model
    jtx = jax_fused_adam(lr=LR, flat=True, use_kernel=True)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jax_llama.loss_fn)(
            params, batch, jcfg, **_jax_kw())
        updates, opt_state = jtx.update(grads, opt_state, params)
        return (jax.tree_util.tree_map(jnp.add, params, updates),
                opt_state, loss)

    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    params, start = _port_params(jparams), _port_params(jparams)
    tx = fused_adam(lr=LR, flat=True)
    state = tx.init(params)
    batch = _port_batch(tokens, targets)
    with pallas_config.force("interpret"):
        jstate, jp = jtx.init(jparams), jparams
        for _ in range(3):
            jp, jstate, jloss = jstep(jp, jstate, jbatch)
            params, state, loss = port_llama.train_step(
                params, state, batch, cfg, tx)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=1e-5)
    for path, ref in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got, p0 = params, start
        for key in path:
            got, p0 = got[key.key], p0[key.key]
        ref_moved = torch.from_numpy(np.asarray(ref)) - p0
        err = torch.linalg.vector_norm((got - p0) - ref_moved)
        assert err <= STEP_RTOL * torch.linalg.vector_norm(ref_moved), (
            jax.tree_util.keystr(path), float(err))
    assert int(state.count) == int(jstate.count) == 3
    for got, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        np.testing.assert_allclose(got["float32"].numpy(),
                                   np.asarray(ref["float32"]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_decoder_layer_keeps_its_contract(model):
    """The MoE layer still returns (x, k, v) through decoder_layer's
    ``ffn``; the aux rides beside it in decoder_layer_with_aux."""
    _, jparams, cfg, tokens, _ = model
    params = _port_params(jparams)
    x = port_llama.embed(params, torch.from_numpy(tokens).long(), cfg)
    pos = torch.arange(x.shape[1]).expand(x.shape[0], -1)
    lp = port_llama.layer(params, 0)
    y, aux = port_llama.decoder_layer_with_aux(x, lp, cfg, pos)
    out, k, v = port_llama.decoder_layer(
        x, lp, cfg, pos, port_llama.causal_attention,
        ffn=lambda h, lp: port_llama._moe_mlp(h, lp, cfg)[0])
    torch.testing.assert_close(out, y, rtol=0, atol=0)
    assert k.shape == (2, 24, cfg.num_kv_heads, cfg.head_dim) == v.shape
    assert aux.dim() == 0 and float(aux) > 0
