"""Parity of the port's GPT-2 decode (apex_tpu_torch.models.generate.
gpt2_generate) with the JAX package's on ``gpt2.tiny()`` params carried
across with ``params_from_numpy``: the prefill and decode layers within
fp32 rounding (JAX's flash and LayerNorm Pallas kernels in interpret
mode, the port's plain versions: 1e-5 relative, 1e-5 absolute), greedy
tokens equal, and the argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generate as jax_gen
from apex_tpu.models import gpt2 as jax_gpt2
from apex_tpu.ops import pallas_config
from apex_tpu_torch.models import generate as port_gen
from apex_tpu_torch.models import gpt2 as port_gpt2

RTOL = ATOL = 1e-5


def _setup(seed=0, **over):
    jcfg, cfg = jax_gpt2.tiny(**over), port_gpt2.tiny(**over)
    jparams = jax_gpt2.init_params(jax.random.PRNGKey(seed), jcfg)
    params = port_gpt2.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _layer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


def test_prefill_and_decode_layers_match_jax():
    jcfg, cfg, jparams, params = _setup(2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, jcfg.hidden_size)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda t: t[1], jparams["layers"])
    lp = _layer(params, 1)
    with pallas_config.force("interpret"):
        jy, jk, jv = jax_gen._gpt2_prefill_layer(jnp.asarray(x), jlp, jcfg)
    y, k, v = port_gen._gpt2_prefill_layer(torch.from_numpy(x), lp, cfg)
    for got, ref in ((y, jy), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    # one decode step at position 9 over a cache holding the prefill
    cache = np.zeros((2, 12, jcfg.num_heads, jcfg.head_dim), np.float32)
    kc, vc = cache.copy(), cache.copy()
    kc[:, :9], vc[:, :9] = np.asarray(jk), np.asarray(jv)
    x1 = rng.standard_normal((2, 1, jcfg.hidden_size)).astype(np.float32)
    jy1, jkc, _ = jax_gen._gpt2_decode_layer(
        jnp.asarray(x1), jlp, jcfg, jnp.asarray(kc), jnp.asarray(vc), 9)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y1 = port_gen._gpt2_decode_layer(torch.from_numpy(x1), lp, cfg, tkc, tvc,
                                     9)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed,p,new", [(0, 8, 6), (1, 5, 12)])
def test_greedy_tokens_match_jax(seed, p, new):
    jcfg, cfg, jparams, params = _setup(seed)
    prompt = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(3, p)).astype(np.int32)
    with pallas_config.force("interpret"):
        ref = np.asarray(jax_gen.gpt2_generate(jparams, jnp.asarray(prompt),
                                               jcfg, new))
    got = port_gen.gpt2_generate(params, torch.from_numpy(prompt).long(),
                                 cfg, new, device="cpu")
    assert got.shape == (3, p + new)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_matches_the_full_forward():
    """Teacher forcing: each generated token is the argmax of the
    full-sequence forward's logits at the position before it."""
    _, cfg, _, params = _setup(3)
    prompt = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    out = port_gen.gpt2_generate(params, prompt, cfg, 10, device="cpu")
    logits = port_gpt2.forward(params, out, cfg, remat=False)
    np.testing.assert_array_equal(
        torch.argmax(logits[:, 5:-1], dim=-1).numpy(), out[:, 6:].numpy())


def test_argument_checks():
    _, cfg, _, params = _setup()
    prompt = torch.zeros((1, 60), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds max_seq_len 64"):
        port_gen.gpt2_generate(params, prompt, cfg, 5, device="cpu")
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        port_gen.gpt2_generate(params, prompt[:, :4], cfg, 2,
                               temperature=0.7, device="cpu")
    jcfg, _, jparams, _ = _setup()
    with pytest.raises(ValueError, match="exceeds max_seq_len 64"):
        jax_gen.gpt2_generate(jparams, jnp.zeros((1, 60), jnp.int32), jcfg,
                              5)


def test_sampling_is_seeded():
    _, cfg, _, params = _setup()
    prompt = torch.zeros((2, 4), dtype=torch.long)

    def sample(seed):
        return port_gen.gpt2_generate(
            params, prompt, cfg, 8, temperature=1.5,
            generator=torch.Generator().manual_seed(seed), device="cpu")

    assert torch.equal(sample(1), sample(1))
    assert not torch.equal(sample(1), sample(2))
