"""The port's registry, fleet identity, event catalog, scopes and timing
against the JAX package's (``apex_tpu.observability``, on the CPU).

The same sequence of counter, gauge, histogram, timer and event calls
gives equal records in both packages (bar the timer's durations); a dump
each package wrote reads in the other's ``read_jsonl`` and ``summarize``
to equal summaries; ``append_event`` and ``dump`` carry the same fleet
stamp at the same ``.rank{i}`` path under ``APEX_TPU_PROCESS_INDEX`` /
``APEX_TPU_PROCESS_COUNT``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as ref_obs
from apex_tpu.observability import events as ref_events
from apex_tpu.observability.fleet import identity as ref_identity
from apex_tpu_torch import observability as obs
from apex_tpu_torch.observability import events
from apex_tpu_torch.observability.fleet import identity
from apex_tpu_torch.runtime import timing

#: timer fields that are durations: measured, so not compared
TIMED = ("total", "min", "max", "mean", "p50", "p90", "p99",
         "total_elapsed")

IDENTITY_ENV = ("APEX_TPU_PROCESS_INDEX", "APEX_TPU_PROCESS_COUNT",
                "APEX_TPU_RUN_ID")


@pytest.fixture(autouse=True)
def _solo(monkeypatch):
    for name in IDENTITY_ENV:
        monkeypatch.delenv(name, raising=False)


def _drive(o, scalar):
    """One fixed sequence of registry calls; ``scalar`` makes the
    package's own 0-d value (a jax array or a tensor)."""
    reg = o.MetricRegistry()
    reg.counter("dispatch", path="flat").inc(3)
    reg.counter("dispatch", path="tree").inc()
    reg.counter("steps").inc(2)
    reg.gauge("loss_scale").set(65536.0)
    reg.gauge("loss_scale").set(32768.0)
    reg.gauge("choice", site="a").set("cuda")
    hist = reg.histogram("step_time_ms")
    for v in np.random.default_rng(0).uniform(1.0, 9.0, size=40):
        hist.observe(v)
    timer = reg.timer("phase", stage="fwd")
    for _ in range(3):
        timer.start()
        timer.stop()
    with reg.timer("ctx").time():
        pass
    reg.event("step", step=0, loss=np.float32(2.5), scale=scalar(4.0))
    reg.event("numerics_stats", source="t", top=[["a", 1.5]],
              arr=np.arange(3), flag=np.bool_(True))
    reg.event("attempt_start")
    return reg


def _untimed(records):
    return [{k: v for k, v in r.items()
             if not (r["type"] == "timer" and k in TIMED)}
            for r in records]


def test_records_equal_the_reference():
    ours = _drive(obs, lambda v: torch.tensor(v))
    ref = _drive(ref_obs, lambda v: jnp.float32(v))
    assert _untimed(ours.to_records()) == _untimed(ref.to_records())
    timer = ours.timer("phase", stage="fwd")
    assert timer.count == 3 and not timer.running
    assert timer.reset_total() >= 0.0 and timer.total_elapsed == 0.0


def test_jsonable_takes_tensors_and_numpy_scalars():
    from apex_tpu_torch.observability.registry import _jsonable

    got = _jsonable({"t": torch.tensor(1.5), "i": torch.tensor(3),
                     "v": torch.arange(3), "n": np.float64(0.25),
                     "b": np.bool_(False), "bf": torch.tensor(
                         2.0, dtype=torch.bfloat16)})
    assert got == {"t": 1.5, "i": 3, "v": [0, 1, 2], "n": 0.25, "b": False,
                   "bf": 2.0}
    json.dumps(got)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_dump(tmp_path, writer):
    ours = _drive(obs, lambda v: torch.tensor(v))
    ref = _drive(ref_obs, lambda v: jnp.float32(v))
    path = str(tmp_path / "metrics.jsonl")
    (ours if writer == "port" else ref).dump(path)
    a = _untimed(obs.read_jsonl(path))
    b = _untimed(ref_obs.read_jsonl(path))
    assert a == b
    sa, sb = obs.summarize(obs.read_jsonl(path)), ref_obs.summarize(
        ref_obs.read_jsonl(path))
    assert sa == sb
    assert sa["counters"]["dispatch{path=flat}"] == 3
    assert sa["gauges"]["loss_scale"] == 32768.0


def test_summarize_and_read_jsonl_equal_on_a_merged_and_truncated_dump(
        tmp_path):
    path = tmp_path / "m.jsonl"
    ours = _drive(obs, lambda v: torch.tensor(v))
    lines = [json.dumps(r) for r in ours.to_records()]
    # two dumps of one run, the second cut mid-line by a killed worker
    path.write_text("\n".join(lines + lines) + "\n" + lines[0][:20] + "\n")
    a, b = obs.read_jsonl(str(path)), ref_obs.read_jsonl(str(path))
    assert a == b and a[-1]["type"] == "parse-error"
    assert obs.summarize(a) == ref_obs.summarize(b)


def test_fleet_stamp_and_rank_paths_match(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PROCESS_INDEX", "1")
    monkeypatch.setenv("APEX_TPU_PROCESS_COUNT", "2")
    monkeypatch.setenv("APEX_TPU_RUN_ID", "run-7")
    out = {}
    for name, o in (("port", obs), ("ref", ref_obs)):
        d = tmp_path / name
        d.mkdir()
        rec = o.append_event(str(d / "m.jsonl"), "preemption",
                             reason="sigterm", step=np.int64(3))
        assert (d / "m.rank1.jsonl").is_file()
        reg = o.MetricRegistry()
        reg.counter("c").inc()
        reg.event("step_done", step=3, duration_s=0.5)
        reg.dump(str(d / "m.jsonl"), mode="a")
        assert o.MetricRegistry.dump_path(str(d / "m.jsonl")) == str(
            d / "m.rank1.jsonl")
        out[name] = (rec, (d / "m.rank1.jsonl").read_text())
    assert out["port"] == out["ref"]
    assert out["port"][0]["process_index"] == 1
    assert out["port"][0]["run_id"] == "run-7"


ENVS = [{}, {"APEX_TPU_PROCESS_INDEX": "0"},
        {"APEX_TPU_PROCESS_INDEX": "2", "APEX_TPU_PROCESS_COUNT": "4"},
        {"APEX_TPU_PROCESS_COUNT": "3"},
        {"APEX_TPU_PROCESS_INDEX": "1", "APEX_TPU_RUN_ID": "r"},
        {"APEX_TPU_PROCESS_INDEX": "5", "APEX_TPU_PROCESS_COUNT": "2"},
        {"APEX_TPU_PROCESS_INDEX": "x"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k[-5:]}={v}" for k, v in e.items()) or "solo")
def test_identity_matches_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def outcome(mod):
        try:
            ident = mod.process_identity()
        except ValueError as e:
            return ("raises", str(e).split(" ")[0])
        return (tuple(ident), mod.is_fleet_member(ident),
                mod.identity_fields(ident),
                [mod.rank_path(p) for p in ("out/m.jsonl", "m",
                                            "a/m.rank3.jsonl", "x.y.z")])

    assert outcome(identity) == outcome(ref_identity)
    for p in ("m.rank2.jsonl", "m.jsonl", "d/m.rank10", "m.ranked"):
        assert identity.rank_of_path(p) == ref_identity.rank_of_path(p)
    assert identity.stamp_environ({}, 3, 4, "r") == \
        ref_identity.stamp_environ({}, 3, 4, "r")


def test_event_catalog_is_the_reference_one():
    assert events.EVENT_CATALOG == ref_events.EVENT_CATALOG
    assert events.GOODPUT_CRITICAL == ref_events.GOODPUT_CRITICAL
    assert obs.EVENT_CATALOG is events.EVENT_CATALOG


def test_scope_and_annotate_name_a_profiler_region():
    @obs.annotate("outer/fn")
    def fn(x):
        with obs.scope("inner/op"):
            return x + 1

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(torch.ones(3))
    names = {e.key for e in prof.key_averages()}
    assert {"outer/fn", "inner/op"} <= names


def test_timing_on_cpu_tensors_uses_the_host_clock():
    x = torch.ones(64, 64)
    assert timing.sync(x) is None and timing.sync({"a": 1}) is None
    t = timing.time_fn(torch.mm, x, x, iters=3, warmup=1)
    assert t.clock == "host" and 0.0 < t < 1.0
    state = (torch.zeros(4),)

    def step(p, b):
        return p + b, (p * b).sum()

    t = timing.time_train_step(step, state, (torch.ones(4),), iters=2)
    assert t.clock == "host" and t > 0

    def adam_like(g, s, p):
        return p - g, s

    assert timing.time_chained(adam_like, x, None, x, iters=2) > 0
    t = timing.time_scanned(lambda: torch.tanh, x,
                            lambda c, f: f(c), k=2, reps=2)
    assert t.clock == "host" and t > 0
    assert timing.fetch_cost(x) >= 0.0
    assert timing.cached_fetch_cost(x) >= 0.0


def test_timer_stop_waits_through_timing_sync(monkeypatch):
    seen = []
    monkeypatch.setattr(timing, "sync", lambda out: seen.append(out))
    reg = obs.MetricRegistry()
    t = reg.timer("fwd")
    t.start()
    out = torch.ones(2)
    assert t.stop(block_on=out) >= 0.0
    assert seen[0] is out and not t.running


#: reference names that later slices port (ROADMAP.md, Queue 1 item 8):
#: absent from the port, never stubbed
LATER = {
    "": {"calibrate_targets"},
    ".memory": {"DEFAULT_CALIBRATION_TARGETS", "calibrate_targets"},
}


@pytest.mark.parametrize("sub", [
    "", ".registry", ".events", ".scope", ".step_report", ".cli",
    ".fleet", ".fleet.identity", ".profiling", ".profiling.spans",
    ".profiling.step_phases", ".profiling.flight_recorder", ".numerics",
    ".numerics.stats", ".numerics.health", ".numerics.nan_probe", ".memory", ".memory.hbm",
    ".memory.oom", ".goodput", ".goodput.ledger", ".goodput.accounting",
    ".recompile", ".memory.compiled", ".profiling.xplane", ".fleet.probe",
    ".fleet.straggler", ".fleet.desync", ".fleet.collector",
    ".fleet.merge"])
def test_the_reference_public_names_are_ported(sub):
    import importlib

    ref = importlib.import_module(f"apex_tpu.observability{sub}")
    ours = importlib.import_module(f"apex_tpu_torch.observability{sub}")
    want = set(getattr(ref, "__all__", None) or (
        n for n in vars(ref) if callable(getattr(ref, n))
        and not n.startswith("_")
        and getattr(getattr(ref, n), "__module__", "") == ref.__name__))
    later = LATER.get(sub, set())
    missing = sorted(n for n in want - later if not hasattr(ours, n))
    assert not missing, missing
    stubs = sorted(n for n in later if hasattr(ours, n))
    assert not stubs, stubs


def test_the_timing_api_is_the_reference_one():
    from apex_tpu.runtime import timing as ref_timing

    for name in ref_timing.__all__ + ["cached_fetch_cost"]:
        assert callable(getattr(timing, name)), name
