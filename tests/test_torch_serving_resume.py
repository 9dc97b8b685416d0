"""The port's serving preemption contract against the JAX package's
(``tests/run_serving/test_chaos.py``, ported) on ``tiny()`` in fp32: the
two engines preempt at the same iteration on one fault spec and dump the
same state and pages, the port resumes to the tokens of JAX's
uninterrupted twin, dumps cross between the packages, a JAX bf16 dump
loads in the port bit for bit, and exit 75, the drain telemetry, the
schema check and a spent fault plan behave as the reference's do. Also
the decode step's static-buffer runner against the eager step on fresh
tensors, across batch compositions, EOS eviction and an in-place defrag.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as jax_obs
from apex_tpu.models import llama as jax_llama
from apex_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from apex_tpu.resilience.loop import Preempted as JaxPreempted
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.resilience import EXIT_PREEMPTED, FaultPlan, Preempted
from apex_tpu_torch.serving import DecodeGraph, ServingEngine
from apex_tpu_torch.serving.engine import (
    _PAGES_FILE,
    _STATE_FILE,
    DUMP_SCHEMA_VERSION,
)

GEOMETRY = dict(page_size=8, max_batch=2, num_pages=32, max_prompt_len=16,
                max_new_cap=16)


def _params(dtype):
    jcfg = jax_llama.tiny(dtype=dtype)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = port_llama.tiny(
        dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    params = port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def model():
    return _params(jnp.float32)


def _port(params, cfg, **kw):
    geo = dict(GEOMETRY, **kw)
    geo.setdefault("registry", port_obs.MetricRegistry())
    return ServingEngine(params, cfg, device="cpu", **geo)


def _jax(params, cfg, **kw):
    geo = dict(GEOMETRY, **kw)
    geo.setdefault("registry", jax_obs.MetricRegistry())
    return JaxEngine(params, cfg, **geo)


def _jobs(cfg, n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(4, 9))) for _ in range(n)]


def _submit_all(engine, jobs):
    for prompt, max_new in jobs:
        engine.submit(prompt, max_new)


def _preempt(engine, jobs, exc=Preempted):
    _submit_all(engine, jobs)
    with pytest.raises(exc) as info:
        engine.run()
    return info.value


@pytest.fixture(scope="module")
def dumps(model, tmp_path_factory):
    """Both engines preempted by ``preempt@4`` on the same jobs, and the
    JAX uninterrupted twin's results."""
    jcfg, jparams, cfg, params = model
    jobs = _jobs(cfg)
    twin = _jax(jparams, jcfg)
    _submit_all(twin, jobs)
    want = twin.run()
    root = tmp_path_factory.mktemp("dumps")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    port = _port(params, cfg, fault_plan=FaultPlan.parse("seed=1,preempt@4"),
                 dump_dir=port_dir)
    port_exc = _preempt(port, jobs)
    ref = _jax(jparams, jcfg, fault_plan=JaxFaultPlan.parse(
        "seed=1,preempt@4"), dump_dir=jax_dir)
    jax_exc = _preempt(ref, jobs, JaxPreempted)
    return dict(jobs=jobs, want=want, port_dir=port_dir, jax_dir=jax_dir,
                port=port, port_exc=port_exc, jax_exc=jax_exc)


def _state(path):
    with open(os.path.join(path, _STATE_FILE)) as f:
        return json.load(f)


def test_preempt_drain_dump_equals_jax(dumps):
    port, exc = dumps["port"], dumps["port_exc"]
    assert exc.exit_code == EXIT_PREEMPTED == 75
    assert exc.step == dumps["jax_exc"].step == 4
    assert port.draining
    with pytest.raises(RuntimeError, match="draining"):
        port.submit(dumps["jobs"][0][0], 4)
    state, ref = _state(dumps["port_dir"]), _state(dumps["jax_dir"])
    # the records hold no times (arrival_s is the trace offset): equal
    assert state == ref
    assert state["schema_version"] == DUMP_SCHEMA_VERSION
    assert state["reason"].startswith("fault-plan preempt")
    inflight = state["inflight"]
    assert inflight and all(rec["tokens"] for rec in inflight)
    accounted = (set(int(r) for r in state["completed"])
                 | {r["rid"] for r in inflight}
                 | {r["rid"] for r in state["queued"]})
    assert accounted == set(range(len(dumps["jobs"])))
    with np.load(os.path.join(dumps["port_dir"], _PAGES_FILE)) as pages, \
            np.load(os.path.join(dumps["jax_dir"], _PAGES_FILE)) as jpages:
        assert sorted(pages.files) == sorted(jpages.files) == sorted(
            f"{kv}_{rec['rid']}" for rec in inflight for kv in "kv")
        # within 1e-6 of each array's largest value: fp32 sums taken in
        # other orders through two layers (worst seen 8.9e-7)
        for name in pages.files:
            assert pages[name].dtype == np.float32
            ref = jpages[name]
            assert (np.abs(pages[name] - ref).max()
                    <= 1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("source", ["port", "jax"])
def test_port_resumes_to_the_uninterrupted_twin(model, dumps, source):
    """Either package's dump, resumed in the port, completes every
    request with the JAX twin's tokens, its decode step never captured
    twice."""
    _, _, cfg, params = model
    resumed = ServingEngine.resume(dumps[f"{source}_dir"], params, cfg,
                                   registry=port_obs.MetricRegistry(),
                                   device="cpu")
    assert resumed.run() == dumps["want"]
    assert resumed.scheduler.decode_retraces() == 0


def test_jax_resumes_a_port_dump(model, dumps):
    jcfg, jparams, _, _ = model
    resumed = JaxEngine.resume(dumps["port_dir"], jparams, jcfg,
                               registry=jax_obs.MetricRegistry())
    assert resumed.run() == dumps["want"]


def test_jax_bf16_dump_loads_in_the_port_bit_equal(tmp_path):
    """``np.savez`` writes the JAX engine's bf16 pages as 2-byte ``|V2``
    items; the port reads them as bf16 bits, and its own bf16 dump is
    the same format."""
    jcfg, jparams, cfg, params = _params(jnp.bfloat16)
    jobs = _jobs(cfg, n=4)
    d = str(tmp_path / "jax")
    _preempt(_jax(jparams, jcfg, fault_plan=JaxFaultPlan.parse(
        "seed=1,preempt@3"), dump_dir=d), jobs, JaxPreempted)
    state = _state(d)
    resumed = ServingEngine.resume(d, params, cfg,
                                   registry=port_obs.MetricRegistry(),
                                   device="cpu")
    cache = resumed.scheduler.cache
    assert cache.k_pages.dtype == torch.bfloat16
    with np.load(os.path.join(d, _PAGES_FILE)) as pages:
        assert state["inflight"]
        for rec in state["inflight"]:
            got = cache.gather_pages(cache.alloc.pages_of(rec["rid"]))
            for kv, tensor in zip("kv", got):
                raw = pages[f"{kv}_{rec['rid']}"]
                assert raw.dtype == np.dtype("V2")
                np.testing.assert_array_equal(
                    tensor.view(torch.int16).numpy(), raw.view(np.int16))
    assert len(resumed.run()) == len(jobs)
    # the port writes bf16 pages in the same raw format
    port_dir = str(tmp_path / "port")
    _preempt(_port(params, cfg, fault_plan=FaultPlan.parse(
        "seed=1,preempt@3"), dump_dir=port_dir), jobs)
    with np.load(os.path.join(port_dir, _PAGES_FILE)) as pages, \
            np.load(os.path.join(d, _PAGES_FILE)) as jpages:
        assert sorted(pages.files) == sorted(jpages.files)
        for name in pages.files:
            assert pages[name].dtype == np.dtype("V2")


def test_exit_on_preempt_exits_75(model, tmp_path):
    _, _, cfg, params = model
    engine = _port(params, cfg, fault_plan=FaultPlan.parse(
        "seed=1,preempt@2"), dump_dir=str(tmp_path / "d"),
        exit_on_preempt=True)
    _submit_all(engine, _jobs(cfg, n=3))
    with pytest.raises(SystemExit) as exc:
        engine.run()
    assert exc.value.code == 75
    assert os.path.exists(str(tmp_path / "d" / _STATE_FILE))


def test_drain_publishes_preemption_telemetry(model, tmp_path):
    _, _, cfg, params = model
    reg = port_obs.MetricRegistry()
    engine = _port(params, cfg, registry=reg,
                   fault_plan=FaultPlan.parse("seed=1,preempt@3"),
                   dump_dir=str(tmp_path / "d"))
    _preempt(engine, _jobs(cfg, n=4))
    records = reg.to_records()
    names = {r["name"]: r for r in records if "name" in r}
    assert names["serving/requests_preempted"]["value"] >= 1
    events = [r for r in records if r.get("type") == "event"
              and r.get("name") == "serving_drain"]
    assert len(events) == 1
    assert events[0]["fields"]["iteration"] == engine.iteration == 3


def test_resume_rejects_schema_drift(model, tmp_path):
    _, _, cfg, params = model
    d = str(tmp_path / "d")
    _preempt(_port(params, cfg, fault_plan=FaultPlan.parse(
        "seed=1,preempt@2"), dump_dir=d), _jobs(cfg, n=3))
    state = _state(d)
    state["schema_version"] = 999
    with open(os.path.join(d, _STATE_FILE), "w") as f:
        json.dump(state, f)
    with pytest.raises(ValueError, match="schema_version"):
        ServingEngine.resume(d, params, cfg,
                             registry=port_obs.MetricRegistry(),
                             device="cpu")


def test_fault_plan_does_not_refire_on_resume(model, tmp_path):
    """should_fire spends the event: the SAME plan instance passed to the
    resumed engine does not preempt it again at the same iteration."""
    _, _, cfg, params = model
    d = str(tmp_path / "d")
    plan = FaultPlan.parse("seed=1,preempt@3")
    _preempt(_port(params, cfg, fault_plan=plan, dump_dir=d),
             _jobs(cfg, n=4))
    resumed = ServingEngine.resume(d, params, cfg, fault_plan=plan,
                                   registry=port_obs.MetricRegistry(),
                                   device="cpu")
    assert len(resumed.run()) == 4


def test_watcher_trip_drains_like_the_fault_plan(model, tmp_path):
    """A tripped PreemptionWatcher drains at the next iteration, its
    reason in the dump."""
    from apex_tpu_torch.resilience import PreemptionWatcher

    _, _, cfg, params = model
    watcher = PreemptionWatcher(registry=port_obs.MetricRegistry())
    d = str(tmp_path / "d")
    engine = _port(params, cfg, watcher=watcher, dump_dir=d)
    _submit_all(engine, _jobs(cfg, n=3))
    engine.step()
    engine.step()
    watcher.trip("maintenance event")
    with pytest.raises(Preempted, match="maintenance event"):
        engine.step()
    assert _state(d)["reason"] == "maintenance event"
    assert _state(d)["iteration"] == 2


# ------------------------------------------- the decode step's static runner


class _Checked(DecodeGraph):
    """The runner, each call held against the eager decode step on fresh
    tensors and copies of the pages: equal tokens, equal page writes."""

    def __init__(self, graph, sched):
        super().__init__(graph.step, graph.device, graph.max_batch,
                         graph.max_pages, graph.pages)
        self.sched = sched
        self.calls = 0

    def __call__(self, tokens, tables, pos, active):
        s = self.sched
        k, v = s.cache.k_pages.clone(), s.cache.v_pages.clone()
        want = s._decode(s.params, s._scales, k, v,
                         torch.from_numpy(tokens.astype(np.int64)),
                         torch.from_numpy(tables.copy()),
                         torch.from_numpy(pos.copy()),
                         torch.from_numpy(active.copy()))
        got = super().__call__(tokens, tables, pos, active)
        np.testing.assert_array_equal(got, want.numpy())
        assert torch.equal(s.cache.k_pages, k)
        assert torch.equal(s.cache.v_pages, v)
        self.calls += 1
        return got


def _defrag(sched):
    """Compact the cache in place and rewrite the block tables."""
    mapping = sched.cache.defrag()
    for row in sched._tables:
        row[:] = [mapping.get(int(p), int(p)) for p in row]
    return mapping


def test_static_runner_equals_the_eager_step(model):
    """Batch compositions change (refills from a queue of 7 on 3 slots),
    a request leaves on EOS, and the cache is defragmented in place
    mid-run: each step's tokens and page writes equal the eager step's,
    the pages keep their storage, and the results equal an unchecked
    engine's."""
    _, _, cfg, params = model
    jobs = _jobs(cfg, n=7, seed=11)
    plain = _port(params, cfg, max_batch=3)
    _submit_all(plain, jobs)
    plain.run()
    eos = plain.results[2]["tokens"][1]
    ref = _port(params, cfg, max_batch=3, eos_id=eos)
    _submit_all(ref, jobs)
    want = ref.run()
    assert len(want[2]["tokens"]) <= 2 < jobs[2][1]

    engine = _port(params, cfg, max_batch=3, eos_id=eos)
    sched = engine.scheduler
    sched._graph = _Checked(sched._graph, sched)
    ptrs = (sched.cache.k_pages.data_ptr(), sched.cache.v_pages.data_ptr())
    _submit_all(engine, jobs)
    moved = {}
    while engine.pending:
        engine.step()
        if not moved and len(engine.results) >= 2 and sched.num_active():
            moved = _defrag(sched)
    assert moved, "the run never had a hole to defragment"
    assert engine.results == want
    assert sched._graph.calls == sched.decode_steps > 0
    assert (sched.cache.k_pages.data_ptr(),
            sched.cache.v_pages.data_ptr()) == ptrs
    assert sched.decode_captures() == sched.decode_retraces() == 0


def test_resume_runs_on_the_card_unless_asked(model, dumps, monkeypatch):
    _, _, cfg, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.resume(dumps["port_dir"], params, cfg,
                             registry=port_obs.MetricRegistry())


def test_launch_counts_move_as_one():
    """The graph runner's counter bookkeeping: a snapshot, the delta of a
    capture, the counters set back, the delta added per replay."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc
    from apex_tpu_torch.ops import launch_counts
    from apex_tpu_torch.ops import layer_norm as ln

    before = launch_counts.snapshot()
    assert len(before) == sum(len(n) for _, n in launch_counts.COUNTERS)
    ln.launches += 65
    fc.col_launches += 224
    moved = launch_counts.delta(launch_counts.snapshot(), before)
    assert moved == {("apex_tpu_torch.ops.layer_norm", "launches"): 65,
                     ("apex_tpu_torch.ops.fp8_cast_kernel",
                      "col_launches"): 224}
    launch_counts.restore(before)
    assert launch_counts.snapshot() == before
    launch_counts.add(moved)
    launch_counts.add(moved)
    assert ln.launches == before[("apex_tpu_torch.ops.layer_norm",
                                  "launches")] + 130
    launch_counts.restore(before)
