"""The port's serving engine with ``weight_mode="fp8"`` against the JAX
package's on llama ``tiny()`` in fp32: the static weight scales, the
greedy tokens of a trace, and the logits of every prefill; and the native
mode left as it was.

Tolerances: the scales are the same fp32 arithmetic on the same values,
so they are equal exactly. The fp8 operands of every product are equal
bit for bit (the cast's contract) and fp8 products are exact in fp32, so
the two engines differ only by the order of fp32 sums: k / v and logits
of size O(1) differ by under 1e-6 on these seeds, and are held to 1e-4
absolute (an activation quantized to the other side of an fp8 rounding
boundary would move them by ~1e-2). The greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as jax_obs
from apex_tpu.models import generate as jax_gen
from apex_tpu.models import llama as jax_llama
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import run_closed_loop as jax_run_closed_loop
from apex_tpu.serving import scheduler as jax_sched
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.serving import (
    ServingEngine,
    fp8_weight_scales,
    make_trace,
    run_closed_loop,
)
from apex_tpu_torch.serving import scheduler as port_sched

GEOMETRY = dict(page_size=8, max_batch=3, num_pages=32, max_prompt_len=24,
                max_new_cap=16)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    params = port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, port_llama.tiny(), params


def _trace(cfg):
    return make_trace(seed=11, num_requests=5, arrival_rate_hz=500.0,
                      prompt_lens=(3, 9, 14), output_lens=(5, 8),
                      vocab_size=cfg.vocab_size)


def test_fp8_weight_scales_equal_jax(model):
    _, jparams, _, params = model
    ref = jax_sched.fp8_weight_scales(jparams)
    got = fp8_weight_scales(params)
    assert sorted(got) == sorted(ref)
    for name, scale in got.items():
        assert scale.dtype == torch.float32
        assert scale.shape == (port_llama.tiny().num_layers,)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ref[name]))


def test_fp8_engine_tokens_and_prefill_logits_equal_jax(model, monkeypatch):
    """Both engines serve one trace in fp8; the logits that pick each
    request's first token are captured on both sides (the JAX prefill's
    through a host callback inside its jit)."""
    jcfg, jparams, cfg, params = model
    port_logits, jax_logits = [], []
    head = port_llama.lm_head

    def port_head(p, x, c):
        out = head(p, x, c)
        if x.shape[1] == 1 and x.shape[0] == 1:  # a prefill's last position
            port_logits.append(out[0, 0].numpy().copy())
        return out

    logits = jax_gen._logits

    def jax_head(p, x, c):
        out = logits(p, x, c)
        if x.shape[:2] == (1, 1):
            jax.debug.callback(lambda v: jax_logits.append(np.array(v)),
                               out[0, 0])
        return out

    trace = _trace(cfg)
    engine = ServingEngine(params, cfg, weight_mode="fp8", device="cpu",
                           registry=port_obs.MetricRegistry(), **GEOMETRY)
    assert engine.scheduler.weight_mode == "fp8"
    monkeypatch.setattr(port_llama, "lm_head", port_head)
    run_closed_loop(engine, trace, use_wall_clock=False)
    ref = JaxEngine(jparams, jcfg, weight_mode="fp8",
                    registry=jax_obs.MetricRegistry(), **GEOMETRY)
    monkeypatch.setattr(jax_gen, "_logits", jax_head)
    jax_run_closed_loop(ref, trace, use_wall_clock=False)
    for tr in trace:
        assert len(engine.results[tr.rid]["tokens"]) == tr.max_new_tokens
        assert engine.results[tr.rid]["tokens"] == \
            ref.results[tr.rid]["tokens"]
    assert len(port_logits) == len(jax_logits) == len(trace)
    for got, want in zip(port_logits, jax_logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_fp8_differs_from_native_but_native_is_unchanged(model):
    """fp8 rounds every operand, so its products move; the native mode's
    product is still the layers' plain matmul."""
    _, _, cfg, params = model
    assert port_sched._make_mm("native") is port_llama.matmul
    x = torch.randn(2, 3, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(0))
    w = params["layers"]["wq"][0]
    torch.testing.assert_close(port_llama.matmul(x, w), torch.matmul(x, w),
                               rtol=0, atol=0)
    mm = port_sched._make_mm("fp8")
    y = mm(x, w, fp8_weight_scales(params)["wq"][0])
    assert y.dtype == x.dtype
    ref = torch.matmul(x, w)
    assert not torch.equal(y, ref)
    # E4M3 keeps 3 mantissa bits: each operand is off by up to 1/16
    assert float((y - ref).abs().max()) <= 0.1 * float(ref.abs().max())
    for mode in ("native", "bf16"):
        engine = ServingEngine(params, cfg, weight_mode=mode, device="cpu",
                               registry=port_obs.MetricRegistry(),
                               **GEOMETRY)
        assert engine.scheduler.weight_mode == "native"
        assert engine.scheduler._scales == {}


def test_fp8_prefill_matches_jax_build_prefill(model):
    """One prefill through each side's ``build_prefill``: the first token
    and every layer's k / v (each the output of an fp8 product) agree."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 16)).astype(np.int32)
    jfn = jax_sched.build_prefill(jcfg, 16, "fp8")
    first_ref, ks_ref, vs_ref = jfn(jparams, jax_sched.fp8_weight_scales(
        jparams), jnp.asarray(prompt), np.int32(13))
    fn = port_sched.build_prefill(cfg, 16, "fp8")
    first, ks, vs = fn(params, fp8_weight_scales(params),
                       torch.from_numpy(prompt).long(), 13)
    assert int(first[0]) == int(np.asarray(first_ref)[0])
    for got, want in ((ks, ks_ref), (vs, vs_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
