"""Parity of the port's llama inference path (apex_tpu_torch.models) with
the JAX package on ``tiny()`` in fp32: params convert with no reshape,
logits match, greedy generation gives the same tokens, and RoPE agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generate as jax_gen
from apex_tpu.models import llama as jax_llama
from apex_tpu.transformer.functional import rope as jax_rope
from apex_tpu_torch.models import generate as port_gen
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.transformer.functional import rope as port_rope


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = port_llama.params_from_numpy(tree, device="cpu")
    return jcfg, jparams, port_llama.tiny(), params


def test_params_from_numpy_keeps_layout(model):
    jcfg, jparams, cfg, params = model
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["layers"]["wq"].shape == (cfg.num_layers, 64, 64)


def test_bf16_params_convert_bit_exact():
    arr = np.asarray(jnp.linspace(-3, 3, 17, dtype=jnp.bfloat16))
    t = port_llama.params_from_numpy({"w": arr}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  arr.astype(np.float32))


def test_forward_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    ref = jax_llama.forward(jparams, jnp.asarray(tokens), jcfg,
                            tp_axis=None, cp_axis=None, remat=False)
    got = port_llama.forward(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_greedy_generate_tokens_equal_jax(model):
    jcfg, jparams, cfg, params = model
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    ref = jax_gen.generate(jparams, jnp.asarray(prompt), jcfg, 7)
    got = port_gen.greedy_generate(params, torch.from_numpy(prompt).long(),
                                   cfg, 7, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_temperature_sampling_needs_generator(model):
    _, _, cfg, params = model
    prompt = torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="Generator"):
        port_gen.generate(params, prompt, cfg, 2, temperature=1.0,
                          device="cpu")
    g = torch.Generator().manual_seed(0)
    out = port_gen.generate(params, prompt, cfg, 4, temperature=1.0,
                            generator=g, device="cpu")
    assert out.shape == (1, 7)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    rq, rk = jax_rope.apply_rotary_qk(jnp.asarray(q), jnp.asarray(k),
                                      positions=jnp.asarray(pos),
                                      base=500000.0)
    gq, gk = port_rope.apply_rotary_qk(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       positions=torch.from_numpy(pos),
                                       base=500000.0)
    np.testing.assert_allclose(gq.numpy(), np.asarray(rq), atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=1e-5)
    # table path and partial rotary dim
    freqs = jax_rope.rotary_freqs(5, 8)
    ref = jax_rope.fused_apply_rotary_pos_emb(jnp.asarray(q),
                                              freqs[None, :, None, :])
    got = port_rope.fused_apply_rotary_pos_emb(
        torch.from_numpy(q), port_rope.rotary_freqs(5, 8)[None, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_init_params_layout_and_default_device():
    cfg = port_llama.tiny()
    g = torch.Generator().manual_seed(0)
    params = port_llama.init_params(g, cfg, device="cpu")
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.tiny())
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert got == shapes
    # fan-in law: N(0, 1/h) for the [h, nq*d] projection
    std = float(params["layers"]["wq"].std())
    assert abs(std - cfg.hidden_size ** -0.5) < 0.02
