"""The port's serving runtime (apex_tpu_torch.serving) against the JAX
package's on ``tiny()`` in fp32: the page allocator and defrag behave
alike, the port's ServingEngine gives the tokens of the port's
generate() and of the JAX ServingEngine on one trace, and EOS eviction
and the submit bounds behave as the reference's do.
"""

import jax
import numpy as np
import pytest
import torch

from apex_tpu import observability as jax_obs
from apex_tpu.models import llama as jax_llama
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import kv_cache as jax_kvc
from apex_tpu.serving import run_closed_loop as jax_run_closed_loop
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch.models import generate as port_gen
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.serving import (
    ServingEngine,
    kv_cache,
    make_trace,
    pages_per_request,
    run_closed_loop,
)

GEOMETRY = dict(page_size=8, max_batch=3, num_pages=32, max_prompt_len=24,
                max_new_cap=16)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    params = port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, port_llama.tiny(), params


def _port_engine(params, cfg, **kw):
    geo = dict(GEOMETRY, **kw)
    return ServingEngine(params, cfg, registry=port_obs.MetricRegistry(),
                         device="cpu", **geo)


def _jax_engine(params, cfg, **kw):
    geo = dict(GEOMETRY, **kw)
    return JaxEngine(params, cfg, registry=jax_obs.MetricRegistry(), **geo)


# ---------------------------------------------------------- allocator


def test_allocator_matches_jax_sequence():
    ops = [("alloc", 2, "r1"), ("alloc", 3, "r2"), ("free", "r1"),
           ("alloc", 3, "r3"), ("free", "r2"), ("alloc", 1, "r4")]
    a, b = kv_cache.PageAllocator(6), jax_kvc.PageAllocator(6)
    for op in ops:
        if op[0] == "alloc":
            assert a.alloc(op[1], op[2]) == b.alloc(op[1], op[2])
        else:
            assert a.free_owner(op[1]) == b.free_owner(op[1])
        assert (a.num_free, a.live_pages()) == (b.num_free, b.live_pages())
    with pytest.raises(RuntimeError, match="out of KV pages"):
        a.alloc(5, "r5")
    with pytest.raises(ValueError):
        a.alloc(0, "r6")
    with pytest.raises(ValueError):
        kv_cache.PageAllocator(0)


def test_defrag_matches_jax_and_moves_data(model):
    jcfg, _, cfg, _ = model
    port = kv_cache.PagedKVCache(cfg, num_pages=8, page_size=4,
                                 device="cpu")
    ref = jax_kvc.PagedKVCache(jcfg, num_pages=8, page_size=4)
    rng = np.random.default_rng(0)
    for cache in (port, ref):
        for owner in "abc":
            cache.alloc.alloc(2, owner=owner)
    ks = rng.standard_normal((cfg.num_layers, 8, cfg.num_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    port.write_prompt(port.alloc.pages_of("c"), torch.from_numpy(ks),
                      torch.from_numpy(ks))
    for cache in (port, ref):
        cache.alloc.free_owner("a")
        cache.alloc.free_owner("b")
    assert port.defrag() == ref.defrag() == {4: 0, 5: 1}
    assert port.alloc.pages_of("c") == ref.alloc.pages_of("c") == [0, 1]
    assert port.alloc.num_free == ref.alloc.num_free == 6
    k, _ = port.gather_pages(port.alloc.pages_of("c"))
    np.testing.assert_array_equal(k.reshape(ks.shape).numpy(), ks)
    assert port.defrag() == {}
    assert port.trash_page == 8 and port.k_pages.shape[1] == 9


def test_page_bytes_match_jax(model):
    jcfg, _, cfg, _ = model
    assert kv_cache.page_hbm_bytes(cfg, 8) == jax_kvc.page_hbm_bytes(jcfg, 8)
    assert (kv_cache.page_hbm_bytes(port_llama.llama3_8b(), 16)
            == 2 * 32 * 16 * 8 * 128 * 2)


# --------------------------------------------------------------- engine


def test_engine_tokens_equal_generate_and_jax_engine(model):
    jcfg, jparams, cfg, params = model
    trace = make_trace(seed=3, num_requests=5, arrival_rate_hz=500.0,
                       prompt_lens=(3, 8, 13), output_lens=(4, 7),
                       vocab_size=cfg.vocab_size)
    assert len({(len(t.prompt), t.max_new_tokens) for t in trace}) >= 3
    engine = _port_engine(params, cfg)
    report = run_closed_loop(engine, trace, use_wall_clock=False)
    assert report["requests"] == 5
    assert report["prefills"] == 5
    ref = _jax_engine(jparams, jcfg)
    jax_run_closed_loop(ref, trace, use_wall_clock=False)
    for tr in trace:
        want = port_gen.generate(
            params, torch.from_numpy(tr.prompt).long()[None], cfg,
            tr.max_new_tokens, device="cpu")[0, len(tr.prompt):].tolist()
        assert engine.results[tr.rid]["tokens"] == want
        assert ref.results[tr.rid]["tokens"] == want
    for key in ("latency_p50_ms", "latency_p99_ms", "ttft_p50_ms",
                "ttft_p99_ms", "tokens_per_s", "mean_occupancy"):
        assert key in report


def test_requests_share_decode_steps(model):
    _, _, cfg, params = model
    engine = _port_engine(params, cfg)
    rng = np.random.default_rng(1)
    for p, max_new in ((4, 8), (6, 8), (9, 8), (4, 6)):
        engine.submit(rng.integers(0, cfg.vocab_size, size=p), max_new)
    max_active = 0
    while engine.pending:
        engine.step()
        max_active = max(max_active, engine.scheduler.num_active())
    assert max_active == 3
    assert engine.mean_occupancy() > 0.5


def test_eos_eviction_matches_jax(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
    ref = port_gen.generate(params, torch.from_numpy(prompt).long()[None],
                            cfg, 12, device="cpu")[0, 6:].tolist()
    eos = ref[3]
    others = [rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
              for p in (4, 7, 5)]
    results = []
    for engine in (_port_engine(params, cfg, max_batch=2, eos_id=eos),
                   _jax_engine(jparams, jcfg, max_batch=2, eos_id=eos)):
        engine.submit(prompt, 12)
        for p in others:
            engine.submit(p, 5)
        results.append(engine.run())
    port_res, jax_res = results
    assert port_res[0]["tokens"] == ref[:ref.index(eos) + 1]
    assert port_res == jax_res


def test_admission_respects_page_budget(model):
    _, _, cfg, params = model
    need = pages_per_request(8, 8, 8)
    engine = _port_engine(params, cfg, max_batch=4, num_pages=need,
                          max_prompt_len=8, max_new_cap=8)
    rng = np.random.default_rng(5)
    for _ in range(3):
        engine.submit(rng.integers(0, cfg.vocab_size, size=8), 8)
    max_active = 0
    while engine.pending:
        engine.step()
        max_active = max(max_active, engine.scheduler.num_active())
    assert max_active == 1
    assert len(engine.results) == 3


def test_submit_bounds_are_loud_like_jax(model):
    jcfg, jparams, cfg, params = model
    for engine in (_port_engine(params, cfg, max_prompt_len=8,
                                max_new_cap=4),
                   _jax_engine(jparams, jcfg, max_prompt_len=8,
                               max_new_cap=4)):
        with pytest.raises(ValueError, match="prompt length"):
            engine.submit(np.zeros(9, np.int32), 2)
        with pytest.raises(ValueError, match="max_new"):
            engine.submit(np.zeros(4, np.int32), 5)
    with pytest.raises(ValueError, match="weight_mode"):
        _port_engine(params, cfg, weight_mode="int3")
    # fp8 is a weight mode of the port too, as of the fp8 cast kernel
    assert _port_engine(params, cfg,
                        weight_mode="fp8").scheduler.weight_mode == "fp8"
    with pytest.raises(ValueError, match="num_pages"):
        _port_engine(params, cfg, num_pages=2)


def test_serving_metric_family_lands_in_registry(model):
    _, _, cfg, params = model
    reg = port_obs.MetricRegistry()
    engine = ServingEngine(params, cfg, registry=reg, device="cpu",
                           **GEOMETRY)
    trace = make_trace(seed=6, num_requests=3, arrival_rate_hz=500.0,
                       prompt_lens=(4, 8), output_lens=(4,),
                       vocab_size=cfg.vocab_size)
    run_closed_loop(engine, trace, use_wall_clock=False)
    names = {r["name"]: r for r in reg.to_records()}
    assert names["serving/requests_submitted"]["value"] == 3
    assert names["serving/requests_completed"]["value"] == 3
    assert names["serving/tokens_generated"]["value"] == 12
    assert names["serving/request_latency_ms"]["count"] == 3
    assert names["serving/ttft_ms"]["count"] == 3
    for gauge in ("serving/batch_occupancy", "serving/page_utilization",
                  "serving/latency_p99_ms", "serving/tokens_per_s",
                  "serving/mean_occupancy"):
        assert gauge in names, f"missing {gauge}"


def test_make_trace_equals_jax_trace():
    from apex_tpu.serving import make_trace as jax_make_trace

    a = make_trace(seed=7, num_requests=6, vocab_size=100)
    b = jax_make_trace(seed=7, num_requests=6, vocab_size=100)
    for x, y in zip(a, b):
        assert (x.rid, x.arrival_s, x.max_new_tokens) == (
            y.rid, y.arrival_s, y.max_new_tokens)
        np.testing.assert_array_equal(x.prompt, y.prompt)
