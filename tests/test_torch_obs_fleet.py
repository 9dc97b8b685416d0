"""The port's fleet tier (``apex_tpu_torch.observability.fleet``: the
grad-sync probe, the straggler and desync detectors, the flight-record
collector and the fleet merge, the ``fleet`` CLI) held against the JAX
package's.

The detectors, the merge and the collector are host code: fed the same
numpy-seeded sequences, matrices and dumps, they must give the
reference's verdicts, events and reports exactly. The fingerprints are
fp32 sums (torch's and XLA's add in their own orders): held at 1e-6
relative; a difference of two such sums (``fingerprint_delta``) is held
at 1e-6 of the fingerprint's largest entry. The multi-rank half runs
``tests/torch_dist_worker.py``'s ``fleet`` suite on 4 gloo ranks on the
CPU (4, so that the median of the ranks' fingerprints can say which
rank moved; at 2 it is the pair's mean and both rows are as far from
it), beside the reference's collectives under ``shard_map`` on 4
simulated host devices.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.observability import cli as ref_cli
from apex_tpu.observability import registry as ref_registry
from apex_tpu.observability.fleet import collector as ref_collector
from apex_tpu.observability.fleet import desync as ref_desync
from apex_tpu.observability.fleet import merge as ref_merge
from apex_tpu.observability.fleet import straggler as ref_straggler
from apex_tpu_torch.observability import cli
from apex_tpu_torch.observability import registry
from apex_tpu_torch.observability.fleet import (
    collector,
    desync,
    merge,
    probe,
    straggler,
)
from apex_tpu_torch.observability.profiling import spans
from torch_dist_worker import FLEET_DELAY_S, run_ranks

FP_RTOL = 1e-6   # fp32 sums in two summation orders
RANKS = 4


@pytest.fixture(autouse=True)
def _probe_off():
    probe.reset()
    yield
    probe.reset()


def _fleet_inputs():
    rng = np.random.default_rng(21)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"fp_a": f32(RANKS, 8, 16), "fp_b": f32(RANKS, 32),
            "g1": f32(RANKS, 33), "g2": f32(RANKS, 4, 5)}


@pytest.fixture(scope="module")
def fleet_ranks(tmp_path_factory):
    inputs = _fleet_inputs()
    directory = tmp_path_factory.mktemp("fleet")
    return inputs, directory, run_ranks("fleet", RANKS, directory, inputs)


# ------------------------------------------------------------ detectors

def _straggler_rounds(mode, seed):
    """Per-rank series of 4 ranks, rank 2 the slow one from round 3."""
    rng = np.random.default_rng(seed)
    rounds = []
    for i in range(12):
        base = rng.uniform(0.8, 1.2, 4)
        if i >= 3:
            base[2] = base[2] * 0.1 if mode == "wait" else base[2] * 3.0
        rounds.append(base.tolist())
    return rounds


def _events(reg):
    return [(r["name"], r.get("fields")) for r in reg.to_records()
            if r["type"] == "event"]


@pytest.mark.parametrize("mode", ["wait", "step_time"])
@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_detector_equals_the_reference(mode, seed):
    ours_reg, ref_reg = registry.MetricRegistry(), \
        ref_registry.MetricRegistry()
    ours = straggler.StragglerDetector(mode=mode, registry=ours_reg)
    ref = ref_straggler.StragglerDetector(mode=mode, registry=ref_reg)
    for step, row in enumerate(_straggler_rounds(mode, seed)):
        # the probe's form ({rank: value}) on odd steps, a list on even
        per_rank = dict(enumerate(row)) if step % 2 else row
        assert ours.observe(step, per_rank) == ref.observe(step, per_rank)
    assert ours.medians() == ref.medians()
    assert ours.verdicts == ref.verdicts and ours.verdicts
    assert ours.verdicts[0]["rank"] == 2
    assert _events(ours_reg) == _events(ref_reg)


def test_straggler_detector_rejects_what_the_reference_rejects():
    for kw in ({"mode": "bogus"}, {"threshold": 0.0}):
        with pytest.raises(ValueError):
            straggler.StragglerDetector(**kw)
        with pytest.raises(ValueError):
            ref_straggler.StragglerDetector(**kw)


def _tree(rng):
    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"layers": {"wq": f32(3, 8, 8), "norm": f32(8)},
            "embed": f32(16, 8), "head": {"b": f32(5)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def test_leaf_paths_and_fingerprint_equal_the_reference():
    tree = _tree(np.random.default_rng(3))
    ours = _torch_tree(tree)
    assert desync.leaf_paths(ours) == ref_desync.leaf_paths(tree)
    got = desync.fingerprint(ours)
    assert got.dtype == torch.float32
    want = np.asarray(ref_desync.fingerprint(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP_RTOL)
    # bf16 leaves are summed in fp32, as the reference casts them
    bf = {"w": torch.tensor(tree["embed"]).to(torch.bfloat16)}
    want_bf = np.asarray(ref_desync.fingerprint(
        {"w": jnp.asarray(tree["embed"]).astype(jnp.bfloat16)}))
    np.testing.assert_allclose(desync.fingerprint(bf).numpy(), want_bf,
                               rtol=FP_RTOL)
    with pytest.raises(ValueError):
        desync.fingerprint({})


def _matrices():
    rng = np.random.default_rng(5)
    row = rng.standard_normal(10).astype(np.float32)
    healthy = np.tile(row, (4, 1))
    drift = healthy.copy()
    drift[3, 7] += 1e-3   # rank 3, leaf 3, abs-sum channel
    sign = healthy.copy()
    sign[1, 2] = -sign[1, 2]   # rank 1, leaf 1, sum channel
    return healthy, drift, sign


@pytest.mark.parametrize("atol", [0.0, 1e-2])
def test_desync_detector_equals_the_reference(atol):
    paths = [f"['l{i}']" for i in range(5)]
    ours_reg, ref_reg = registry.MetricRegistry(), \
        ref_registry.MetricRegistry()
    ours = desync.DesyncDetector(paths, atol=atol, registry=ours_reg)
    ref = ref_desync.DesyncDetector(paths, atol=atol, registry=ref_reg)
    healthy, drift, sign = _matrices()
    for step, mat in enumerate((healthy, drift, healthy, sign)):
        got = ours.check(step, torch.tensor(mat))   # a tensor, as gathered
        assert got == ref.check(step, mat)
    assert ours.verdicts == ref.verdicts
    assert ours.first_divergent_step == ref.first_divergent_step
    assert _events(ours_reg) == _events(ref_reg)
    if atol == 0.0:
        assert [(v["rank"], v["tensor_path"], v["channel"])
                for v in ours.verdicts] == [(3, "['l3']", "abs_sum"),
                                            (1, "['l1']", "sum")]
    with pytest.raises(ValueError):
        ours.check(9, healthy[:, :4])


# ------------------------------------------------------------- 2 ranks

def _ref_per_rank(fn, tree_of_stacked, n=RANKS):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    out = jax.jit(shard_map(
        lambda t: fn(jax.tree_util.tree_map(lambda v: v[0], t))[None],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp")))(
        jax.tree_util.tree_map(jnp.asarray, tree_of_stacked))
    return np.asarray(out)


def test_fingerprint_gather_equals_the_reference_mesh(fleet_ranks):
    inputs, _, ranks = fleet_ranks
    stacked = {"b": inputs["fp_b"], "a": {"w": inputs["fp_a"]}}
    want = _ref_per_rank(
        lambda t: ref_desync.fingerprint_gather(t, "dp"), stacked)
    for r, out in enumerate(ranks):
        assert out["gather"].shape == (RANKS, 2 * 2)
        np.testing.assert_allclose(out["gather"], want[r], rtol=FP_RTOL)


def test_fingerprint_delta_is_zero_on_replicas_only(fleet_ranks):
    inputs, _, ranks = fleet_ranks
    drift = np.stack([inputs["fp_a"][0]] * RANKS)
    drift[1, 0, 0] += 1e-3
    want = _ref_per_rank(
        lambda t: ref_desync.fingerprint_delta(t, "dp"), {"w": drift})
    # the delta is a difference of sums: held against the sums' scale
    scale = float(np.abs(drift[0]).sum())
    for r, out in enumerate(ranks):
        assert float(out["delta_same"]) == 0.0
        assert float(out["delta_drift"]) > 0.0
        np.testing.assert_allclose(out["delta_drift"], want[r], rtol=0,
                                   atol=FP_RTOL * scale)


def test_probe_is_bit_for_bit_and_names_the_delayed_rank(fleet_ranks):
    _, directory, ranks = fleet_ranks
    site = "ddp/bucket/float32"
    for r, out in enumerate(ranks):
        assert bool(out["probe_equal"])
        assert list(out["wait_sites"]) == [site]
        assert str(out["last_collective"]) == site
    # the others wait for the delayed rank 1 at every round; it does not
    for r, out in enumerate(ranks):
        if r != 1:
            assert out["wait_s"][0] > 0.5 * FLEET_DELAY_S
    assert ranks[1]["wait_s"][0] < 0.5 * FLEET_DELAY_S
    report = merge.merge_fleet(str(directory / "metrics.jsonl"))
    assert report["rank_count"] == RANKS
    assert report["wait_skew"][site]["min_rank"] == 1
    (verdict,) = report["stragglers"]
    assert verdict["rank"] == 1 and verdict["mode"] == "wait"
    assert verdict["metric"] == f"fleet/grad_sync_wait_s{{site={site}}}"
    # the merge's records carry the wait-pass straggler as a counter
    recs = merge.fleet_metric_records(report)
    assert {"type": "counter", "name": "fleet/stragglers",
            "labels": {"rank": "1"}, "value": 1} in recs


def test_fleet_cli_names_the_delayed_rank(fleet_ranks, capsys, tmp_path):
    _, directory, _ = fleet_ranks
    base = str(directory / "metrics.jsonl")
    out_path = tmp_path / "fleet.jsonl"
    assert cli.main(["fleet", base, "--emit-metrics", str(out_path)]) == 0
    text = capsys.readouterr().out
    assert "STRAGGLER rank 1" in text and "grad-sync wait" in text
    assert out_path.stat().st_size > 0
    assert cli.main(["fleet", base, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["rank_count"] == RANKS


def test_flight_records_carry_the_probe_and_merge_as_the_reference(
        fleet_ranks, capsys):
    _, directory, ranks = fleet_ranks
    paths = sorted(str(p) for p in directory.glob("flightrec_*.json"))
    assert len(paths) == RANKS
    for path in paths:
        payload = json.load(open(path))
        assert payload["last_collective"] == "ddp/bucket/float32"
        assert payload["last_collectives"] == {
            str(payload["process_index"]): "ddp/bucket/float32"}
    ours = collector.merge_flight_records(paths)
    assert ours == ref_collector.merge_flight_records(paths)
    assert ours["rank_count"] == RANKS
    assert {info["last_collective"] for info in ours["ranks"].values()} \
        == {"ddp/bucket/float32"}
    assert cli.main(["fleet", "--flight", str(directory),
                     "--no-write"]) == 0
    assert "last_collective=ddp/bucket/float32" in capsys.readouterr().out


def test_desync_detector_under_the_loop_names_rank_leaf_and_step(
        fleet_ranks):
    _, _, ranks = fleet_ranks
    for out in ranks:
        assert int(out["healthy_verdicts"]) == 0
        assert not bool(out["healthy_aborted"])
        verdict = json.loads(str(out["verdict"]))
        assert (verdict["rank"], verdict["tensor_path"], verdict["step"],
                verdict["first_divergent_step"]) == (1, "['w']", 2, 2)
        assert verdict["divergent_ranks"] == [1]


def test_probe_disabled_is_the_identity():
    x = torch.ones(3)
    assert not probe.enabled()
    assert probe.collective_enter(x, "s", "data") is x
    assert probe.collective_exit(x, "s", "data") is x
    assert probe.wait_times() == {} and probe.last_collective() is None


def test_probe_env_switch_and_detector_rounds(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FLEET_PROBE", "1")
    assert probe.enabled()
    probe.disable()
    assert not probe.enabled()
    reg = registry.MetricRegistry()
    det = straggler.StragglerDetector(mode="wait", min_history=1,
                                      registry=reg)
    probe.set_detector(det)
    prev = registry.set_registry(reg)
    try:
        # two local ranks of one process, rank 1 entering late
        for _ in range(2):
            probe._on_enter("site", 0)
            probe._on_enter("site", 1)
            probe._on_exit("site", 1)
            probe._on_exit("site", 0)
    finally:
        registry.set_registry(prev)
    assert probe.last_collectives() == {0: "site", 1: "site"}
    assert set(probe.wait_times()) == {("site", 0), ("site", 1)}
    timers = [r for r in reg.to_records()
              if r["name"] == "fleet/grad_sync_wait_s"]
    assert {r["labels"]["rank"] for r in timers} == {"0", "1"}


# -------------------------------------------------------- merge readers

def _step_time_dumps(directory, ours: bool):
    """Three ranks' metrics shards written by each package's registry,
    rank 2's steps 3x the others'."""
    mod = registry if ours else ref_registry
    rng = np.random.default_rng(8)
    for rank in range(3):
        reg = mod.MetricRegistry()
        for _ in range(8):
            ms = rng.uniform(90, 110) * (3.0 if rank == 2 else 1.0)
            reg.histogram("train/step_time_ms").observe(ms)
        reg.counter("train/steps").inc(8)
        if rank == 1:
            reg.event("fleet/desync", step=4, rank=1, tensor_path="['w']")
        with open(directory / f"metrics.rank{rank}.jsonl", "w") as f:
            for rec in reg.to_records():
                rec.pop("time", None)
                f.write(json.dumps(rec) + "\n")


def _strip(report):
    """A report without its shard paths (the two dumps' directories
    differ)."""
    return {**report, "ranks": {k: {**v, "path": None}
                                for k, v in report["ranks"].items()}}


def test_merge_fleet_equals_the_reference(tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    _step_time_dumps(a, ours=True)
    _step_time_dumps(b, ours=False)
    ours = merge.merge_fleet(str(a / "metrics.jsonl"))
    ref = ref_merge.merge_fleet(str(b / "metrics.jsonl"))
    assert _strip(ours) == _strip(ref)
    assert [v["rank"] for v in ours["stragglers"]] == [2]
    assert "wait_skew" not in ours   # no probe timers in these dumps
    assert merge.fleet_metric_records(ours) == \
        ref_merge.fleet_metric_records(ref)
    # the reference's reader on the port's dumps, and the other way
    assert _strip(ref_merge.merge_fleet(str(a / "metrics.jsonl"))) == \
        _strip(ours)
    assert merge.fleet_shards(str(a)) == [
        (r, str(a / f"metrics.rank{r}.jsonl")) for r in range(3)]
    with pytest.raises(FileNotFoundError):
        merge.merge_fleet(str(tmp_path / "none.jsonl"))


def test_fleet_trace_events_equal_the_reference(tmp_path):
    dumps = []
    for rank in range(2):
        tracer = spans.SpanTracer(capacity=64)
        for name in ("step", "ddp/bucket/float32"):
            tracer.begin(name)
            tracer.end()
        path = tmp_path / f"spans.rank{rank}.json"
        tracer.save(str(path))
        dumps.append((rank, str(path)))
    ours = merge.fleet_trace_events(dumps)
    assert ours == ref_merge.fleet_trace_events(dumps)
    assert {ev["pid"] for ev in ours} == {0, 1}
    out = tmp_path / "t.json"
    assert cli.main(["fleet", *(p for _, p in dumps), "--trace",
                     str(out)]) == 0
    assert ref_cli.main(["fleet", *(p for _, p in dumps), "--trace",
                         str(tmp_path / "r.json")]) == 0
    assert json.load(open(out)) == json.load(open(tmp_path / "r.json"))
