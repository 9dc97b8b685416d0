"""The port's checkpoint/state-flow checks on the CPU (``apex_tpu_torch.
analysis.state_checks``, the counterpart of the JAX package's): an
aligned pair for each of the five ids (a small JAX program with the
hazard through ``apex_tpu.analysis``, its torch counterpart through the
port, both naming the id; a clean twin of each naming none); state
written in place counted as carried (the functional trace's writes); the
code-derived schema equal to ``checkpoint.state_schema_of``; the
constructor tags; ``reshard-illegal`` on the port's ZeRO-1 padding; and
the registry's zero-filled counters."""

import jax
import jax.numpy as jnp
import pytest
import torch

from apex_tpu.analysis import state_checks as ref
from apex_tpu.checkpoint import state_schema_of as ref_schema_of
from apex_tpu.resilience.loop import resume_path as ref_resume_path
from apex_tpu_torch import checkpoint
from apex_tpu_torch.analysis import interp, state_checks as port
from apex_tpu_torch.observability.registry import MetricRegistry
from apex_tpu_torch.resilience.loop import resume_path


@pytest.fixture
def jax_graph_compat(monkeypatch):
    """The JAX package's graph engines name ``jax.core.Var``, which newer
    jax moved to ``jax.extend.core``: alias it for this test."""
    import jax.extend.core as ext

    for name in ("Var", "ClosedJaxpr", "Jaxpr", "Literal", "JaxprEqn"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(ext, name),
                                raising=False)


def _ids(findings):
    return sorted({f.check for f in findings})


def _fake(make):
    return interp.on_trace_device(make)


def _jax_state():
    return {"w": jnp.ones((4, 4), jnp.float32),
            "m": jnp.zeros((4, 4), jnp.float32)}


def _jax_step(state, g):
    m = 0.9 * state["m"] + 0.1 * g
    return {"w": state["w"] - 0.1 * m, "m": m}


def _torch_state():
    return _fake(lambda dev: ({"w": torch.ones((4, 4), device=dev),
                               "m": torch.zeros((4, 4), device=dev)},
                              torch.ones((4, 4), device=dev)))


def _torch_step(state, g):
    m = 0.9 * state["m"] + 0.1 * g
    return {"w": state["w"] - 0.1 * m, "m": m}


def _bucket_layout(total=30, padded=32, num_shards=4):
    return {"axis": "dp", "num_shards": num_shards,
            "buckets": [{"dtype": "float32", "total": total,
                         "padded": padded}]}


def _jax_unsaved(clean):
    save = None if clean else (lambda s: {"w": s["w"]})
    return ref.analyze_state(_jax_step, _jax_state(), jnp.ones((4, 4)),
                             save_tree_of=save)


def _torch_unsaved(clean):
    state, g = _torch_state()
    save = None if clean else (lambda s: {"w": s["w"]})
    return port.analyze_state(_torch_step, state, g, save_tree_of=save)


def _jax_drift(clean):
    state = _jax_state()
    manifest = ref_schema_of(state)
    if not clean:
        manifest["leaves"][1]["dtype"] = "float16"
    return ref.analyze_state(_jax_step, state, jnp.ones((4, 4)),
                             manifest=manifest)


def _torch_drift(clean):
    state, g = _torch_state()
    manifest = checkpoint.state_schema_of(state)
    if not clean:
        manifest["leaves"][1]["dtype"] = "float16"
    return port.analyze_state(_torch_step, state, g, manifest=manifest)


def _jax_narrowing(clean):
    state = {"master": jnp.ones((4,), jnp.float32)}
    slot = {"master": jnp.ones((4,), jnp.float32 if clean
                               else jnp.bfloat16)}
    return ref.analyze_state(lambda s, g: {"master": s["master"] - g},
                             state, jnp.ones((4,)), restore_template=slot)


def _torch_narrowing(clean):
    state, slot, g = _fake(lambda dev: (
        {"master": torch.ones(4, device=dev)},
        {"master": torch.ones(4, dtype=torch.float32 if clean
                              else torch.bfloat16, device=dev)},
        torch.ones(4, device=dev)))
    return port.analyze_state(lambda s, g: {"master": s["master"] - g},
                              state, g, restore_template=slot)


def _jax_reshard(clean):
    return ref.analyze_state(
        _jax_step, _jax_state(), jnp.ones((4, 4)),
        reshard_layout=_bucket_layout(),
        reshard_candidates=(4, 8, 16, 32) if clean else (3,))


def _torch_reshard(clean):
    state, g = _torch_state()
    return port.analyze_state(
        _torch_step, state, g, reshard_layout=_bucket_layout(),
        reshard_candidates=(4, 8, 16, 32) if clean else (3,))


def _jax_restore(clean):
    def raw(state, step):
        w = state["w"] * 0.9 + step
        return {"w": w}, {"loss": jnp.mean(w)}

    step_fn = jax.jit(raw) if clean else jax.jit(raw, donate_argnums=(0,))
    return ref.check_restore_donation(
        ref_resume_path(step_fn), {"w": jnp.ones((4, 4))}, jnp.float32(0))


def _torch_restore(clean):
    state, step = _fake(lambda dev: ({"w": torch.ones((4, 4), device=dev)},
                                     torch.zeros((), device=dev)))

    def step_fn(state, step):
        if clean:
            w = state["w"] * 0.9 + step
        else:
            # the torch form of donating the state: the step overwrites it
            w = state["w"].mul_(0.9).add_(step)
        return {"w": w}, {"loss": torch.mean(w)}

    return port.check_restore_donation(resume_path(step_fn), state, step)


PAIRS = {
    "unsaved-train-state": (_jax_unsaved, _torch_unsaved),
    "ckpt-schema-drift": (_jax_drift, _torch_drift),
    "dtype-narrowing-restore": (_jax_narrowing, _torch_narrowing),
    "reshard-illegal": (_jax_reshard, _torch_reshard),
    "restore-donation-hazard": (_jax_restore, _torch_restore),
}


@pytest.mark.parametrize("clean", [False, True], ids=["hazard", "clean"])
@pytest.mark.parametrize("check", sorted(PAIRS))
def test_aligned_pair(jax_graph_compat, check, clean):
    jax_prog, torch_prog = PAIRS[check]
    want = [] if clean else [check]
    assert _ids(jax_prog(clean)) == want
    assert _ids(torch_prog(clean)) == want


def test_every_state_id_has_a_pair():
    assert set(PAIRS) == set(port.STATE_CHECKS) == set(ref.STATE_CHECKS)


def test_state_written_in_place_is_carried():
    """The mutation trap: a moment updated in place and never returned is
    still step-carried, so dropping it from the save tree is flagged."""
    state, g = _torch_state()

    def step(state, g):
        state["m"].mul_(0.9).add_(0.1 * g)
        return state["w"] - 0.1 * state["m"]

    schema = port.derive_state_schema(step, state, g)
    assert [(lf.path, lf.carried) for lf in schema.leaves] == [
        ("['m']", True), ("['w']", True)]
    found = port.analyze_state(step, state, g,
                               save_tree_of=lambda s: {"w": s["w"]})
    assert _ids(found) == ["unsaved-train-state"]
    assert "['m']" in found[0].message


def test_a_leaf_the_step_never_reads_is_not_carried():
    state, g = _fake(lambda dev: ({"w": torch.ones(4, device=dev),
                                   "unused": torch.ones(4, device=dev)},
                                  torch.ones(4, device=dev)))
    schema = port.derive_state_schema(
        lambda s, g: {"w": s["w"] - g}, state, g)
    assert {lf.path: lf.carried for lf in schema.leaves} == {
        "['unused']": False, "['w']": True}


def test_code_schema_is_the_checkpoint_writers_and_the_references():
    """The engine's manifest encoding equals what ``save_checkpoint``
    writes (``state_schema_of``), which equals the JAX package's for the
    same state: a fresh save compares drift-free."""
    state, g = _torch_state()
    covered, paths, leaves, treedef, _ = port.trace_save_coverage(
        lambda s: s, state)
    code = port.StateSchema(treedef=str(treedef), leaves=tuple(
        port.StateLeaf(path=p, shape=tuple(lf.shape),
                       dtype=port._dtype_name(lf), spec=None)
        for p, lf in zip(paths, leaves))).to_manifest()
    assert code == checkpoint.state_schema_of(state)
    assert code["fingerprint"] == ref_schema_of(_jax_state())["fingerprint"]
    assert covered == {0, 1}


def test_constructor_kind_is_named_in_a_finding():
    from apex_tpu_torch.observability.numerics.history import AmaxHistory

    hist = AmaxHistory(["a", "b"], length=4)
    state, amax = _fake(lambda dev: (
        {"w": torch.ones(4, device=dev), "hist": hist.init(dev)},
        torch.ones(2, device=dev)))

    def step(s, amax):
        new = hist.update(s["hist"], amax)
        return {"w": s["w"] * hist.amax(new)[0], "hist": new}

    assert port.leaf_kinds(state) == (
        "AmaxHistoryState.ring", "AmaxHistoryState.cursor",
        "AmaxHistoryState.filled", None)
    found = port.analyze_state(step, state, amax,
                               save_tree_of=lambda s: {"w": s["w"]})
    assert _ids(found) == ["unsaved-train-state"]
    assert len(found) == 3
    assert all("AmaxHistoryState." in f.message for f in found)


def test_reshard_on_the_zero1_padding():
    """``reshard-illegal`` as arithmetic over the port's ZeRO-1 plan (no
    collective traced): the optimizer's own elastic candidates are pure
    reshards, a count off its padding quantum is not."""
    from apex_tpu_torch.parallel.zero import Zero1FusedAdam

    opt = Zero1FusedAdam(lr=1e-3, axis_name="dp", num_shards=4,
                         bucket_cap_mb=0.1)
    params, g = _fake(lambda dev: (
        {"w": torch.zeros((250, 3), device=dev),
         "b": torch.zeros((7,), device=dev)},
        torch.ones(4, device=dev)))
    layout = opt.state_layout(params)
    good = opt.elastic_candidates(params)
    assert good and 4 in good
    bad = tuple(n for n in range(1, 9) if n not in good)
    assert bad

    def step(s, g):
        return {k: v * 0.9 for k, v in s.items()}

    assert port.analyze_state(step, params, g, reshard_layout=layout,
                              reshard_candidates=good) == []
    found = port.analyze_state(step, params, g, reshard_layout=layout,
                               reshard_candidates=bad)
    assert _ids(found) == ["reshard-illegal"]


def test_restore_without_a_held_reference_or_after_a_clone_is_clean():
    state, step = _fake(lambda dev: ({"w": torch.ones((4, 4), device=dev)},
                                     torch.zeros((), device=dev)))

    def in_place(state, step):
        w = state["w"].mul_(0.9).add_(step)
        return {"w": w}, {"loss": torch.mean(w)}

    def cloned(state, step):
        return in_place({k: v.clone() for k, v in state.items()}, step)

    assert port.check_restore_donation(
        resume_path(in_place, holds_fallback=False), state, step) == []
    assert port.check_restore_donation(resume_path(cloned), state,
                                       step) == []


def test_unknown_state_check_raises_and_bad_manifest_is_loud():
    state, g = _torch_state()
    with pytest.raises(ValueError, match="unknown state check"):
        port.analyze_state(_torch_step, state, g, checks=("nope",))
    with pytest.raises(TypeError, match="manifest"):
        port.analyze_state(_torch_step, state, g, manifest=3)
    with pytest.raises(ValueError, match="diverged"):
        port.analyze_state(_torch_step, state, g, specs=[None])


def test_report_to_registry_zero_fills():
    reg = MetricRegistry()
    found = _torch_unsaved(clean=False)
    counts = port.report_to_registry(
        {"t": (found, {"carried": 2, "saved_leaves": 1})}, registry=reg)
    assert counts == dict({c: 0 for c in port.STATE_CHECKS},
                          **{"unsaved-train-state": 1})
    names = {r.get("name") for r in reg.to_records()}
    assert {"analysis/state_findings", "analysis/state_carried_leaves",
            "analysis/state_saved_leaves"} <= names
