"""The port's checkpoints (apex_tpu_torch.checkpoint) against the JAX
package's (apex_tpu.checkpoint, orbax underneath).

What the two share is the durability protocol: the ``_APEX_COMMIT.json``
marker, its file manifest and its format-2 ``state_schema``. For the
same state both packages write the same schema (fingerprint included),
and each package's validators and GC judge the other's directories the
same way. The data differs: the port writes one ``.npy`` a leaf beside
an ``index.json``, which numpy alone reads. Round trips are bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as jax_ckpt
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.resilience import FaultPlan as JaxFaultPlan
from apex_tpu.resilience import inject_checkpoint_failures as jax_inject
from apex_tpu_torch import _tree
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.amp.scaler import LossScaler as PortLossScaler
from apex_tpu_torch.optimizers import fused_adam as port_fused_adam
from apex_tpu_torch.resilience import (
    DiskFull,
    FaultPlan,
    Policy,
    TornWrite,
    inject_checkpoint_failures,
)


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f32(2, 3), "b": f32(3), "bf": f32(4, 5),
            "i": rng.integers(-9, 9, (3,)).astype(np.int32)}


def _jax_state(arrs):
    params = {"w": jnp.asarray(arrs["w"]), "b": jnp.asarray(arrs["b"])}
    return {"params": params, "opt": jax_fused_adam(lr=1e-2).init(params),
            "misc": {"bf": jnp.asarray(arrs["bf"], jnp.bfloat16),
                     "i": jnp.asarray(arrs["i"])},
            "scaler": JaxLossScaler(init_scale=2.0 ** 8).init()}


def _port_state(arrs):
    params = {"w": torch.from_numpy(arrs["w"].copy()),
              "b": torch.from_numpy(arrs["b"].copy())}
    return {"params": params, "opt": port_fused_adam(lr=1e-2).init(params),
            "misc": {"bf": torch.from_numpy(arrs["bf"]).to(torch.bfloat16),
                     "i": torch.from_numpy(arrs["i"].copy())},
            "scaler": PortLossScaler(init_scale=2.0 ** 8).init()}


def _leaves(state):
    return [x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
            for x in _tree.flatten(state)[0]]


def _jax_leaves(state):
    return [np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16
            else np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


# ------------------------------------------------------------- the schema

def test_treedef_and_paths_read_as_jax_writes_them():
    tree = {"a": [1, 2.0, (None, np.int32(3))], "b": None,
            "c": (torch.ones(2),), "d": np.float32(2), "e": True,
            "o": port_fused_adam().init({"w": torch.ones(2)})}
    jtree = {"a": [1, 2.0, (None, np.int32(3))], "b": None,
             "c": (jnp.ones(2),), "d": np.float32(2), "e": True,
             "o": jax_fused_adam().init({"w": jnp.ones(2)})}
    pairs, treedef = _tree.flatten_with_path(tree)
    jflat, jdef = jax.tree_util.tree_flatten_with_path(jtree)
    assert str(treedef) == str(jdef)
    assert [p for p, _ in pairs] == [jax.tree_util.keystr(k)
                                     for k, _ in jflat]
    assert treedef.unflatten([leaf for _, leaf in pairs])["o"].mu["w"] is \
        tree["o"].mu["w"]


@pytest.mark.parametrize("step", [None, 7])
def test_markers_agree_for_the_same_state(tmp_path, step):
    arrs = _numpy_state()
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"),
                                     _jax_state(arrs), step=step)
    ppath = ckpt.save_checkpoint(str(tmp_path / "port"), _port_state(arrs),
                                 step=step)
    jm, pm = jax_ckpt.read_manifest(jpath), ckpt.read_manifest(ppath)
    assert pm["format"] == jm["format"] == 2
    assert pm["step"] == jm["step"] == step
    assert pm["state_schema"] == jm["state_schema"]
    assert pm["state_schema"] == ckpt.state_schema_of(_port_state(arrs))
    kinds = {leaf["kind"] for leaf in pm["state_schema"]["leaves"]}
    assert "LossScaleState.loss_scale" in kinds


def test_fingerprint_moves_with_the_state():
    arrs = _numpy_state()
    a = ckpt.state_schema_of(_port_state(arrs))
    assert a == ckpt.state_schema_of(_port_state(_numpy_state(1)))
    state = _port_state(arrs)
    state["misc"]["bf"] = state["misc"]["bf"].float()
    assert ckpt.state_schema_of(state)["fingerprint"] != a["fingerprint"]
    assert ckpt.schema_fingerprint(a) == a["fingerprint"]
    assert ckpt.encode_spec(("dp", None, ("tp", "sp"))) == [
        "dp", None, ["tp", "sp"]] == jax_ckpt.encode_spec(
        ("dp", None, ("tp", "sp")))
    with pytest.raises(ValueError, match="diverged"):
        ckpt.state_schema_of(state, specs=[None])


def test_format1_marker(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    (d / "x.bin").write_bytes(b"abc")
    ckpt.write_commit_marker(str(d), step=3)
    assert ckpt.read_manifest(str(d)) == json.loads(
        (d / ckpt.COMMIT_MARKER).read_text())
    assert ckpt.read_manifest(str(d))["format"] == 1
    assert ckpt.manifest_state_schema(str(d)) is None
    assert ckpt.validate_step_dir(str(d), deep=True)
    assert jax_ckpt.validate_step_dir(str(d), deep=True)


# ------------------------------------------------------ cross-validation

def _torn(pkg, inject, plan_cls, directory, state, step):
    with inject(plan_cls.parse(f"ckpt_torn@{step}")):
        with pytest.raises(OSError):
            pkg.save_checkpoint(directory, state, step=step)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_validators_judge_each_others_dirs(tmp_path, writer):
    arrs = _numpy_state()
    d = str(tmp_path / "run")
    if writer == "jax":
        pkg, state, inject, plan = (jax_ckpt, _jax_state(arrs), jax_inject,
                                    JaxFaultPlan)
    else:
        pkg, state, inject, plan = (ckpt, _port_state(arrs),
                                    inject_checkpoint_failures, FaultPlan)
    for step in (1, 2):
        pkg.save_checkpoint(d, state, step=step)
    _torn(pkg, inject, plan, d, state, 3)
    # a committed dir corrupted in place, its size kept
    victim = os.path.join(d, "step_00000002")
    name = next(n for n in sorted(os.listdir(victim))
                if n != ckpt.COMMIT_MARKER
                and os.path.getsize(os.path.join(victim, n)) > 0)
    with open(os.path.join(victim, name), "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))
    for mod in (jax_ckpt, ckpt):
        assert mod.latest_step(d) == 2
        assert mod.valid_steps(d) == [1, 2]
        assert mod.valid_steps(d, deep=True) == [1]
        assert mod.latest_valid_step(d, deep=True) == 1
        assert mod.validate_step_dir(os.path.join(d, "step_00000001"),
                                     deep=True)
        assert not mod.validate_step_dir(os.path.join(d, "step_00000003"
                                                      + ckpt.TMP_SUFFIX))
    removed = ckpt.gc_partial_checkpoints(d)
    assert [os.path.basename(p) for p in removed] == ["step_00000003.tmp"]
    # a truncated file fails the size check: both GCs remove the dir
    with open(os.path.join(victim, name), "r+b") as f:
        f.truncate(1)
    gc = ckpt if writer == "jax" else jax_ckpt
    assert [os.path.basename(p) for p in gc.gc_partial_checkpoints(d)] == [
        "step_00000002"]
    assert sorted(os.listdir(d)) == ["step_00000001"]


@pytest.mark.parametrize("max_to_keep", [0, 2])
@pytest.mark.parametrize("async_save", [False, True])
def test_retention_keeps_the_same_steps(tmp_path, max_to_keep, async_save):
    """Saves 1..5 with step 4's torn and step 5's data corrupted after its
    commit: both managers keep the same dirs, the newest valid one among
    them."""
    arrs = _numpy_state()
    kept = {}
    for name, mod, state, inject, plan in (
            ("jax", jax_ckpt, _jax_state(arrs), jax_inject, JaxFaultPlan),
            ("port", ckpt, _port_state(arrs), inject_checkpoint_failures,
             FaultPlan)):
        d = str(tmp_path / name)
        mgr = mod.CheckpointManager(d, max_to_keep=max_to_keep,
                                    async_save=async_save)
        with inject(plan.parse("ckpt_torn@4")):
            for step in range(1, 6):
                try:
                    mgr.save(step, state)
                except OSError:
                    pass
            try:
                mgr.wait_until_finished()
            except OSError:
                pass
        step5 = os.path.join(d, "step_00000005")
        for root, _dirs, files in os.walk(step5):
            for f in files:
                if f != ckpt.COMMIT_MARKER:
                    with open(os.path.join(root, f), "ab") as fh:
                        fh.write(b"x")
        mgr.save(6, state)
        mgr.wait_until_finished()
        kept[name] = (sorted(os.listdir(d)), mgr.latest_valid_step())
    assert kept["port"] == kept["jax"]
    assert kept["port"][1] == 6


def test_retention_never_deletes_the_only_valid_step(tmp_path):
    d = str(tmp_path / "run")
    mgr = ckpt.CheckpointManager(d, max_to_keep=1)
    state = _port_state(_numpy_state())
    mgr.save(1, state)
    with inject_checkpoint_failures(FaultPlan.parse("ckpt_torn@2")):
        with pytest.raises(TornWrite):
            mgr.save(2, state)
    assert ckpt.valid_steps(d) == [1]


# ------------------------------------------------------------- round trip

def test_round_trip_is_bit_for_bit_into_the_target(tmp_path):
    arrs = _numpy_state()
    state = _port_state(arrs)
    path = ckpt.save_checkpoint(str(tmp_path), state, step=0)
    target = _port_state(_numpy_state(5))
    ids = [id(t) for t in _tree.flatten(target)[0]]
    got = ckpt.restore_checkpoint(str(tmp_path), target=target)
    assert [id(t) for t in _tree.flatten(got)[0]] == ids  # in place
    assert type(got["opt"]) is type(state["opt"])
    for a, b in zip(_tree.flatten(got)[0], _tree.flatten(state)[0]):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert got["opt"].count.device.type == "cpu"
    assert ckpt.validate_step_dir(path, deep=True)


def test_restore_without_target_lands_on_the_device_asked(tmp_path):
    state = _port_state(_numpy_state())
    ckpt.save_checkpoint(str(tmp_path), state, step=4)
    got = ckpt.restore_checkpoint(str(tmp_path), device="cpu")
    assert set(got) == {"params", "opt", "misc", "scaler"}
    assert set(got["opt"]) == {"count", "mu", "nu"}  # fields, as a dict
    assert got["misc"]["bf"].dtype == torch.bfloat16
    assert torch.equal(got["misc"]["bf"].view(torch.int16),
                       state["misc"]["bf"].view(torch.int16))
    assert torch.equal(got["params"]["w"], state["params"]["w"])


def test_python_and_numpy_leaves_round_trip(tmp_path):
    state = {"t": torch.arange(3), "n": np.arange(4, dtype=np.int16),
             "s": np.float32(1.5), "f": 2.5, "i": 7, "b": True,
             "l": [None, torch.zeros(2)]}
    ckpt.save_checkpoint(str(tmp_path), state)
    got = ckpt.restore_checkpoint(str(tmp_path), device="cpu")
    assert got["f"] == 2.5 and got["i"] == 7 and got["b"] is True
    assert got["n"].dtype == np.int16 and got["l"][0] is None
    target = {"t": torch.zeros(3, dtype=torch.int64),
              "n": np.zeros(4, np.int16), "s": np.float32(0), "f": 0.0,
              "i": 0, "b": False, "l": [None, torch.ones(2)]}
    got = ckpt.restore_checkpoint(str(tmp_path), target=target)
    assert got["i"] == 7 and got["s"] == np.float32(1.5)
    assert torch.equal(target["t"], torch.arange(3))


@pytest.mark.parametrize("change", ["shape", "dtype", "structure"])
def test_a_mismatched_target_raises(tmp_path, change):
    state = _port_state(_numpy_state())
    ckpt.save_checkpoint(str(tmp_path), state)
    target = _port_state(_numpy_state())
    if change == "shape":
        target["params"]["w"] = torch.zeros(3, 2)
    elif change == "dtype":
        target["misc"]["bf"] = target["misc"]["bf"].float()
    else:
        target["misc"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), target=target)


def test_numpy_alone_reads_a_port_checkpoint(tmp_path):
    """The leaves equal the JAX state's, read through index.json with
    numpy and nothing else (bf16 as |V2 bits); the marker's treedef is
    JAX's."""
    arrs = _numpy_state()
    path = ckpt.save_checkpoint(str(tmp_path), _port_state(arrs), step=1)
    with open(os.path.join(path, ckpt.INDEX)) as f:
        index = json.load(f)
    jflat, jdef = jax.tree_util.tree_flatten_with_path(_jax_state(arrs))
    assert ckpt.manifest_state_schema(path)["treedef"] == str(jdef)
    assert len(index["leaves"]) == len(jflat)
    for meta, (kp, leaf) in zip(index["leaves"], jflat):
        assert meta["path"] == jax.tree_util.keystr(kp)
        arr = np.load(os.path.join(path, meta["file"]))
        want = np.asarray(leaf)
        if meta["dtype"] == "bfloat16":
            assert arr.dtype == np.dtype("V2")
            arr = arr.view(np.uint16)
            want = want.view(np.uint16)
        assert arr.dtype == want.dtype and arr.shape == want.shape
        np.testing.assert_array_equal(arr, want)


def test_jax_state_restored_into_the_port_equals_it(tmp_path):
    """A state carried across by value (numpy) and restored from a port
    checkpoint equals the JAX state leaf for leaf."""
    arrs = _numpy_state()
    ckpt.save_checkpoint(str(tmp_path), _port_state(arrs))
    got = ckpt.restore_checkpoint(str(tmp_path),
                                  target=_port_state(_numpy_state(3)))
    for a, b in zip(_leaves(got), _jax_leaves(_jax_state(arrs))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the protocol

def test_fault_points_and_overwrite(tmp_path):
    state = _port_state(_numpy_state())
    d = str(tmp_path)
    with inject_checkpoint_failures(FaultPlan.parse("ckpt_enospc@1")):
        with pytest.raises(DiskFull):
            ckpt.save_checkpoint(d, state, step=1)
    assert os.listdir(d) == []  # nothing written before the disk filled
    with inject_checkpoint_failures(FaultPlan.parse("ckpt_torn@1")):
        with pytest.raises(TornWrite):
            ckpt.save_checkpoint(d, state, step=1)
    assert os.listdir(d) == ["step_00000001.tmp"]
    assert ckpt.latest_valid_step(d) is None
    ckpt.save_checkpoint(d, state, step=1)  # the stale tmp is replaced
    assert os.listdir(d) == ["step_00000001"]
    with pytest.raises(ValueError, match="overwrite=False"):
        Policy(max_attempts=3, sleep=lambda s: None).call(
            ckpt.save_checkpoint, d, state, step=1, overwrite=False)
    with inject_checkpoint_failures(FaultPlan.parse("ckpt_torn@-1")):
        with pytest.raises(TornWrite):
            ckpt.save_checkpoint(str(tmp_path / "plain"), state)


def test_restore_falls_back_to_a_markerless_dir(tmp_path):
    state = _port_state(_numpy_state())
    ckpt.save_checkpoint(str(tmp_path), state, step=2)
    os.remove(os.path.join(tmp_path, "step_00000002", ckpt.COMMIT_MARKER))
    assert ckpt.latest_valid_step(str(tmp_path)) is None
    got = ckpt.restore_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert ckpt.gc_partial_checkpoints(str(tmp_path)) == []


# ------------------------------------------------------------------ async

def test_async_save_writes_the_state_as_it_was_at_save(tmp_path):
    """The port's steps update tensors in place: a state mutated right
    after ``save`` returns must still be written as it was at ``save``,
    and a second save reuses the snapshot buffers."""
    writer = ckpt.AsyncCheckpointWriter()
    state = _port_state(_numpy_state())
    want = [t.clone() for t in _tree.flatten(state)[0]]
    writer.save(str(tmp_path), state, step=0)
    assert writer.in_flight_tmp.endswith("step_00000000.tmp")
    with torch.no_grad():
        for t in _tree.flatten(state)[0]:
            t.add_(1)
    buffers = writer._buffers
    writer.save(str(tmp_path), state, step=1)  # fences and commits step 0
    assert writer._buffers is buffers
    writer.wait()
    assert writer.in_flight_tmp is None
    assert ckpt.valid_steps(str(tmp_path), deep=True) == [0, 1]
    got0 = ckpt.restore_checkpoint(str(tmp_path), step=0,
                                   target=_port_state(_numpy_state(1)))
    got1 = ckpt.restore_checkpoint(str(tmp_path), step=1,
                                   target=_port_state(_numpy_state(1)))
    for a, b in zip(_tree.flatten(got0)[0], want):
        assert torch.equal(a, b)
    for a, now in zip(_tree.flatten(got1)[0], _tree.flatten(state)[0]):
        assert torch.equal(a, now)
    assert ckpt.manifest_state_schema(
        os.path.join(tmp_path, "step_00000000")) == ckpt.state_schema_of(state)
    writer.close()


def test_async_torn_commit_leaves_the_previous_step(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    state = _port_state(_numpy_state())
    writer.save(str(tmp_path), state, step=1)
    with inject_checkpoint_failures(FaultPlan.parse("ckpt_torn@2")):
        writer.save(str(tmp_path), state, step=2)
        with pytest.raises(TornWrite):
            writer.wait()
    assert ckpt.valid_steps(str(tmp_path)) == [1]
    assert writer.in_flight_tmp is None  # a torn write does not wedge
    writer.save(str(tmp_path), state, step=3)
    writer.close()
    assert ckpt.valid_steps(str(tmp_path)) == [1, 3]


def test_manager_gc_spares_the_write_in_flight(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=1,
                                 async_save=True)
    state = _port_state(_numpy_state())
    mgr.save(1, state)
    assert mgr._writer.in_flight_tmp is not None
    mgr.save(2, state)  # commits 1, starts 2; GC keeps 2's tmp
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002.tmp"]
    mgr.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    assert mgr.restore(target=state)["params"]["w"] is state["params"]["w"]


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.asarray(2.5),
    np.zeros((0, 3), np.int32), np.arange(10, dtype=np.int16).view("V2"),
    np.asarray(True), np.arange(24.0).reshape(2, 3, 4)[:, ::2]],
    ids=["f32", "scalar", "empty", "bf16_bits", "bool", "strided"])
def test_leaf_files_are_np_save_bytes(tmp_path, arr):
    """A leaf file is byte for byte what ``np.save`` writes, and its
    size and crc32 are the manifest's."""
    import io
    import zlib

    path = str(tmp_path / "leaf.npy")
    meta = ckpt._write_npy(path, arr)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    with open(path, "rb") as f:
        data = f.read()
    assert data == buf.getvalue()
    assert meta == {"size": len(data), "crc32": zlib.crc32(data)}
