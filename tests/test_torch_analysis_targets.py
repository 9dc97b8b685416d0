"""The port's registered graph-engine targets on the CPU
(``apex_tpu_torch.analysis.targets``): every target traces, names the same
check ids as the JAX package's target of the same name (both at none: the
reference gate's baseline grandfathers nothing), falls under the same
engine; ``step-record-schema`` as an aligned pair; and the precision and
state runners publish their counts to the registry."""

import jax
import pytest

from apex_tpu.analysis import cli as ref_cli
from apex_tpu.analysis import findings as ref_findings
from apex_tpu.analysis import targets as ref_targets
from apex_tpu_torch.analysis import cli, targets
from apex_tpu_torch.observability.registry import MetricRegistry


@pytest.fixture
def jax_graph_compat(monkeypatch):
    """The JAX package's graph engines name ``jax.core.Var``, a Pallas
    ``BlockMapping.array_shape_dtype`` and int block dims, which newer jax
    moved (``jax.extend.core``, ``array_aval``, ``Blocked``): alias them
    for this test."""
    import jax.extend.core as ext

    for name in ("Var", "ClosedJaxpr", "Jaxpr", "Literal", "JaxprEqn"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(ext, name),
                                raising=False)
    from jax._src.pallas import core as pallas_core

    bm = pallas_core.BlockMapping
    if not hasattr(bm, "array_shape_dtype"):
        monkeypatch.setattr(bm, "array_shape_dtype",
                            property(lambda self: self.array_aval),
                            raising=False)
    if hasattr(pallas_core, "Blocked"):
        get = bm.__getattribute__

        def getattribute(self, name):
            value = get(self, name)
            if name == "block_shape":
                return tuple(getattr(d, "block_size", d) for d in value)
            return value
        monkeypatch.setattr(bm, "__getattribute__", getattribute)


def _ids(findings):
    return sorted({f.check for f in findings})


def test_the_registered_targets():
    assert set(targets.TARGETS) <= set(ref_targets.TARGETS)
    assert set(targets.PRECISION_TARGETS) == set(
        ref_targets.PRECISION_TARGETS)
    assert set(targets.STATE_TARGETS) <= set(ref_targets.STATE_TARGETS)
    assert len(targets.TARGETS) == 19


@pytest.mark.parametrize("name", sorted(targets.TARGETS))
def test_target_traces_with_the_references_ids(jax_graph_compat, name):
    found, errors = targets.run_targets({name})
    assert errors == {}
    ref_found, ref_errors = ref_targets.run_targets({name})
    assert ref_errors == {}, ref_errors
    assert _ids(found) == _ids(ref_found) == []
    assert all(f.symbol == name for f in found)
    assert cli.target_engine(name) == ref_cli.target_engine(name)
    # the reference gate grandfathers nothing of the target either
    base = ref_findings.load_baseline(
        ref_cli.os.path.join(ref_cli.os.path.dirname(ref_targets.__file__),
                             "..", "..", "tests", "run_analysis",
                             "baseline.json"))
    assert not [k for k in base if f":<jaxpr:{name}>:" in k]


@pytest.mark.parametrize("clean", [False, True], ids=["hazard", "clean"])
def test_step_record_schema_pair(monkeypatch, clean):
    """A documented field the record lacks fails both packages' target."""
    from apex_tpu.observability import step_report as ref_report
    from apex_tpu_torch.observability import step_report

    if not clean:
        for mod in (ref_report, step_report):
            monkeypatch.setattr(mod, "STEP_RECORD_FIELDS",
                                mod.STEP_RECORD_FIELDS + ("no_such_field",))
    want = [] if clean else ["step-record-schema"]
    ref_found, _ = ref_targets.run_targets({"step-record-schema"})
    found, _ = targets.run_targets({"step-record-schema"})
    assert _ids(ref_found) == _ids(found) == want


def test_allow_drops_a_targets_check(monkeypatch):
    from apex_tpu_torch.observability import step_report

    monkeypatch.setattr(step_report, "STEP_RECORD_FIELDS",
                        step_report.STEP_RECORD_FIELDS + ("no_such_field",))
    got, _ = targets.run_targets(
        {"step-record-schema"},
        extra_allow={"step-record-schema": {"step-record-schema"}})
    assert got == []


def test_run_precision_findings_publishes():
    reg = MetricRegistry()
    found, errors = targets.run_precision_findings(
        registry=reg, names={"tp_fused_softmax", "mlp_train_step"})
    assert (found, errors) == ([], {})
    records = {r.get("name"): r for r in reg.to_records()}
    assert records["analysis/precision_findings_total"]["value"] == 0


def test_run_state_findings_zero_fills_and_counts_leaves():
    reg = MetricRegistry()
    found, errors, stats = targets.run_state_findings(
        registry=reg, names=("state_resilient_resume_path",
                             "state_serving_decode_step"))
    assert (found, errors) == ([], {})
    assert stats == {
        "state_resilient_resume_path": {"carried": 1, "saved_leaves": 1,
                                        "reshard_candidates": 0},
        "state_serving_decode_step": {"carried": 4, "saved_leaves": 4,
                                      "reshard_candidates": 0}}
    counters = [r for r in reg.to_records()
                if r.get("name") == "analysis/state_findings"]
    assert sorted(r["labels"]["check"] for r in counters) == sorted(
        targets.STATE_CHECKS)
    with pytest.raises(ValueError, match="unknown state target"):
        targets.run_state_findings(names=("nope",))


def test_state_llama_o4_step_carries_every_leaf():
    targets.run_targets({"state_llama_o4_step"})
    stats = targets.STATE_STATS["state_llama_o4_step"]
    assert stats["carried"] == stats["saved_leaves"] > 0
