"""Parity of the port's MoE generation (apex_tpu_torch.models.generate,
``cfg.moe``) with the JAX package's: the prefill and decode expert paths
against ``_moe_prefill_ffn``/``_moe_decode_ffn`` (fp32, the same inputs;
within fp32 rounding), greedy tokens equal to JAX's ``generate`` for
top-2 and top-1 on ``tiny(num_layers=2, num_experts=4,
moe_capacity_factor=8.0)`` (JAX's Pallas kernels in interpret mode, the
port's plain versions), and the serving engine refusing MoE configs, as
the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generate as jax_gen
from apex_tpu.models import llama as jax_llama
from apex_tpu.ops import pallas_config
from apex_tpu_torch.models import generate as port_gen
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.serving import ContinuousBatchScheduler, ServingEngine
from apex_tpu_torch.serving.scheduler import build_decode_step, build_prefill


def _cfgs(k: int):
    kw = dict(num_layers=2, num_experts=4, moe_capacity_factor=8.0,
              moe_top_k=k)
    return jax_llama.tiny(**kw), port_llama.tiny(**kw)


def _port(jparams):
    return port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("k", [2, 1])
@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_moe_ffns_match_jax(path, k):
    """The generation experts on one layer's params: every expert masked
    by the combine weights (prefill, [b, s, h]) and the per-token weight
    gather (decode, [b, 1, h])."""
    jcfg, cfg = _cfgs(k)
    jparams = jax_llama.init_params(jax.random.PRNGKey(3), jcfg)
    jlp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"])
    lp = port_llama.layer(_port(jparams), 0)
    s = 7 if path == "prefill" else 1
    x = np.random.default_rng(k).standard_normal(
        (3, s, jcfg.hidden_size)).astype(np.float32)
    jfn = getattr(jax_gen, f"_moe_{path}_ffn")
    fn = getattr(port_gen, f"_moe_{path}_ffn")
    ref = jfn(jnp.asarray(x), jlp, jcfg)
    got = fn(torch.from_numpy(x), lp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the router weights: the same experts, gates within fp32 rounding
    rg, ri = jax_gen._moe_router_weights(jnp.asarray(x.reshape(-1, 64)),
                                         jlp, jcfg)
    gg, gi = port_gen._moe_router_weights(torch.from_numpy(
        x.reshape(-1, 64)), lp, cfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gg.numpy(), np.asarray(rg), rtol=1e-6)


@pytest.mark.parametrize("k", [2, 1])
def test_greedy_moe_tokens_match_jax(k):
    """Greedy MoE generate: the port's tokens equal JAX's."""
    jcfg, cfg = _cfgs(k)
    jparams = jax_llama.init_params(jax.random.PRNGKey(1), jcfg)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    with pallas_config.force("interpret"):
        ref = np.asarray(jax_gen.generate(jparams, jnp.asarray(prompt), jcfg,
                                          6))
    got = port_gen.generate(_port(jparams), torch.from_numpy(prompt).long(),
                            cfg, 6, device="cpu")
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_moe_sampling_runs_from_a_generator():
    _, cfg = _cfgs(2)
    params = port_llama.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    prompt = torch.zeros(2, 5, dtype=torch.long)
    a = port_gen.generate(params, prompt, cfg, 4, temperature=1.0,
                          generator=torch.Generator().manual_seed(7),
                          device="cpu")
    b = port_gen.generate(params, prompt, cfg, 4, temperature=1.0,
                          generator=torch.Generator().manual_seed(7),
                          device="cpu")
    assert torch.equal(a, b) and a.shape == (2, 9)


def test_serving_refuses_moe_configs():
    """The engine is dense-only, as the reference's is (scheduler.py:133,
    :198, :257)."""
    _, cfg = _cfgs(2)
    params = port_llama.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="dense-only"):
        ContinuousBatchScheduler(params, cfg, num_pages=32, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-only"):
        ServingEngine(params, cfg, num_pages=32, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-only"):
        build_decode_step(cfg, 8)
    with pytest.raises(NotImplementedError, match="dense-only"):
        build_prefill(cfg, 16)
