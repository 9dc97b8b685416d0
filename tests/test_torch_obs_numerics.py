"""The numerics tier and the step report against the JAX package's.

A seeded numpy tree (fp32, bf16 with subnormals, fp16 with an inf,
fp32 with a nan, an integer leaf that must be skipped) goes through
``host_tensor_stats`` in both packages: ``amax`` and ``finite`` exact,
``l2`` within 1e-6 relative, ``underflow_frac`` and ``zero_frac`` within
1e-7 absolute; a leaf reduced in several chunks equals its whole-leaf
reduction to the same tolerance. ``summarize_stats``, ``HealthMonitor``,
``LossScaler.report`` and ``StepReporter.step`` give equal results on
equal inputs.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import observability as ref_obs
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.observability import numerics as ref_numerics
from apex_tpu.observability import step_report as ref_step_report
from apex_tpu_torch import observability as obs
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.observability import numerics
from apex_tpu_torch.observability import step_report
from apex_tpu_torch.observability.numerics import stats as stats_mod


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal(256).astype(np.float32)
    bf[:24] = rng.uniform(1e-41, 1e-39, 24)  # bf16 subnormals
    bf[24:40] = 0.0
    half = rng.standard_normal((3, 7)).astype(np.float16)
    half[0, :3] = np.float16(3e-6)  # fp16 subnormals
    half[1, 2] = np.inf
    nan = rng.standard_normal((5, 9)).astype(np.float32)
    nan[2, 2] = np.nan
    return {
        "layers": {"wq": rng.standard_normal((37, 5)).astype(np.float32),
                   "norm": bf.astype(ml_dtypes.bfloat16)},
        "half": half,
        "bad": nan,
        "ids": np.arange(4, dtype=np.int32),
        "pair": [rng.standard_normal(2).astype(np.float32), None],
    }


def _to_torch(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _to_jax(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_jax(v) for v in x]
    return jnp.asarray(x)


def _assert_stats_close(got, want):
    assert list(got) == list(want)
    for path in want:
        g, w = got[path], want[path]
        assert g["finite"] == w["finite"], path
        if math.isnan(w["amax"]):
            assert math.isnan(g["amax"]), path
        else:
            assert g["amax"] == w["amax"], path
        if math.isfinite(w["l2"]):
            assert abs(g["l2"] - w["l2"]) <= 1e-6 * abs(w["l2"]), path
        else:
            assert (math.isnan(g["l2"]) and math.isnan(w["l2"])
                    or g["l2"] == w["l2"]), path
        for f in ("underflow_frac", "zero_frac"):
            assert abs(g[f] - w[f]) <= 1e-7, (path, f, g[f], w[f])


def test_host_tensor_stats_match_the_reference():
    tree = _tree_np()
    ours = numerics.host_tensor_stats(_to_torch(tree))
    ref = ref_numerics.host_tensor_stats(_to_jax(tree))
    _assert_stats_close(ours, ref)
    assert "ids" not in ours
    assert ours["layers/norm"]["underflow_frac"] > 0.05
    assert ours["half"]["underflow_frac"] > 0.1
    assert numerics.leaf_paths(_to_torch(tree)) == \
        ref_numerics.leaf_paths(_to_jax(tree))
    assert numerics.tree_paths(_to_torch(tree)) == \
        ref_numerics.tree_paths(_to_jax(tree))
    assert numerics.nonfinite_paths(_to_torch(tree)) == \
        ref_numerics.nonfinite_paths(_to_jax(tree)) == ("bad", "half")


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_summarize_stats_matches(top_k):
    tree = _tree_np(1)
    ours = numerics.summarize_stats(
        numerics.host_tensor_stats(_to_torch(tree)), top_k=top_k)
    ref = ref_numerics.summarize_stats(
        ref_numerics.host_tensor_stats(_to_jax(tree)), top_k=top_k)
    assert [p for p, _ in ours["worst_amax"]] == \
        [p for p, _ in ref["worst_amax"]]
    for key in ("tensors", "finite", "nonfinite_paths"):
        assert ours[key] == ref[key]
    assert ours["amax_max"] == ref["amax_max"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_chunked_reduction_equals_the_whole_leaf(monkeypatch, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    x[::7] = 0.0
    x[1::11] = 1e-40 if dtype != torch.float16 else 1e-6
    leaf = torch.from_numpy(x).to(dtype)
    whole = numerics.host_tensor_stats({"w": leaf})
    monkeypatch.setattr(stats_mod, "CHUNK_ELEMENTS", 96)  # 11 chunks
    chunked = numerics.host_tensor_stats({"w": leaf})
    _assert_stats_close(chunked, whole)


def test_stats_collector_publishes_the_reference_family():
    tree = _tree_np(3)
    out = []
    for mod, conv in ((numerics, _to_torch), (ref_numerics, _to_jax)):
        reg = (obs if mod is numerics else ref_obs).MetricRegistry()
        col = mod.StatsCollector("t", every=2, registry=reg)
        assert col.observe(conv(tree), 1) is None
        summary = col.observe(conv(tree), 2)
        assert summary["stats_pass_ms"] >= 0.0 and col.last is summary
        out.append(sorted((m.kind, m.name, tuple(sorted(m.labels.items())))
                          for m in reg.metrics()))
        out.append([e["name"] for e in reg.events()])
    assert out[0] == out[2] and out[1] == out[3]


def _health_events(mod, registry):
    mon = mod.HealthMonitor("h", registry=registry, plateau_window=4,
                            min_samples=3)
    losses = [4.0, 3.9, 3.8, 3.7, 60.0, 3.6, 3.6, 3.6, 3.6, 3.6,
              float("nan"), 3.5]
    grads = [1.0, 1.1, 0.9, 1.0, 1.2, 40.0, 1.0, 1.0, float("inf"), 1.0,
             1.0, 1.0]
    streaks = [0, 0, 1, 2, 3, 4, 0, 0, 0, 1, 3, 0]
    fired = []
    for step, (loss, g, k) in enumerate(zip(losses, grads, streaks)):
        fired.append(mon.observe(step, loss=loss, grad_norm=g,
                                 scaler_report={
                                     "skip_streak": k,
                                     "last_overflow_step": step,
                                     "loss_scale": 2.0 ** (10 - k)}))
    return fired, registry.events()


def test_health_monitor_emits_the_reference_events():
    ours = _health_events(numerics, obs.MetricRegistry())
    ref = _health_events(ref_numerics, ref_obs.MetricRegistry())
    assert ours == ref
    assert {e["event"] for f in ours[0] for e in f} == {
        "numerics_loss_spike", "numerics_grad_spike", "numerics_nonfinite",
        "numerics_loss_plateau", "numerics_overflow_streak"}


def test_loss_scaler_report_matches_the_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32) * 1e3,
         "c": rng.standard_normal(2).astype(np.float32)}
    g["c"][1] = np.inf
    seq = [False, True, True, False, True, True, True, False]
    reports = []
    for scaler, conv, o in ((LossScaler(init_scale=2.0 ** 10), _to_torch,
                             obs),
                            (RefScaler(init_scale=2.0 ** 10), _to_jax,
                             ref_obs)):
        reg = o.MetricRegistry()
        state = scaler.init()
        got = []
        for ovf in seq:
            state = scaler.update(state, ovf)
            got.append(scaler.report(state, registry=reg,
                                     grads=conv(g) if ovf else None))
        gauges = sorted((m.name, m.value) for m in reg.metrics())
        events = [(e["name"], e["fields"]) for e in reg.events()]
        reports.append((got, gauges, events))
    assert reports[0] == reports[1]
    assert reports[0][0][-2]["top_offenders"][0][0] == "c"


def test_step_record_fields_are_the_reference_ones():
    assert step_report.STEP_RECORD_FIELDS == \
        ref_step_report.STEP_RECORD_FIELDS
    assert obs.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert obs.peak_flops("NVIDIA H100 PCIe") == 989e12
    assert obs.peak_flops("cpu") is None and obs.peak_flops(None) is None
    assert step_report.transformer_step_flops(10, 2, 8, 16, 4) == \
        ref_step_report.transformer_step_flops(10, 2, 8, 16, 4)


def test_step_records_equal_the_reference(monkeypatch):
    monkeypatch.delenv("APEX_TPU_PROCESS_INDEX", raising=False)
    monkeypatch.delenv("APEX_TPU_PROCESS_COUNT", raising=False)
    monkeypatch.delenv("APEX_TPU_RUN_ID", raising=False)
    for mod in (step_report, ref_step_report):
        monkeypatch.setattr(mod, "peak_flops", lambda kind: 2.5e12)
    out = []
    for mod, o, scaler, conv in (
            (step_report, obs, LossScaler(), torch.tensor),
            (ref_step_report, ref_obs, RefScaler(), jnp.asarray)):
        reg = o.MetricRegistry()
        rep = mod.StepReporter("t", registry=reg, tokens_per_step=4096,
                               flops_per_step=3e12, device_kind="dev")
        state = scaler.update(scaler.init(), True)
        recs = [rep.step(0.125, loss=conv(2.5), scaler_state=state,
                         grad_norm=conv(0.75), numerics={"finite": True},
                         memory={"live_bytes": 10},
                         phases={"data": 0.1, "compute": 0.9}),
                rep.step(2.0, loss=3.0, extra_field="x")]
        out.append((recs, reg.to_records(), rep.summary()))
    assert out[0] == out[1]
    assert out[0][0][0]["mfu"] is not None
    with pytest.raises(ValueError):
        step_report.StepReporter("t").step(0.0)


def test_reporter_on_the_cpu_has_no_peak():
    rep = obs.StepReporter("cpu_run", registry=obs.MetricRegistry(),
                           flops_per_step=1e9)
    rec = rep.step(0.5, loss=1.0)
    if not torch.cuda.is_available():
        assert rec["mfu"] is None and "device_kind" not in rec
    assert rec["tflops_per_sec"] == 0.0
