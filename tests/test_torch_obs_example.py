"""The 3-D example's observability tiers on 2 gloo CPU ranks (pp 2), read
back with the JAX package's reader.

The ``llama_tiers`` suite of ``tests/torch_example_suites.py`` runs the
example's steps with the tiers off, then from the same init with them
on, and ends as ``main`` does under ``APEX_TPU_METRICS``. Each rank's
``metrics.rank<r>.jsonl`` reads in the reference's ``read_jsonl`` and
``summarize``; every step record has the reference's
``STEP_RECORD_FIELDS`` and phase fractions in [0, 1]; step 0's record
carries a ``numerics`` block; the losses with the tiers on equal those
with them off, bit for bit. The launcher gives each rank its fleet
identity: the example launched through it writes ``.rank0`` and
``.rank1`` dumps.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from apex_tpu.observability import read_jsonl, summarize
from apex_tpu.observability.step_report import STEP_RECORD_FIELDS
from torch_dist_worker import run_ranks

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    directory = tmp_path_factory.mktemp("llama_tiers")
    return directory, run_ranks("llama_tiers", 2, directory, {},
                                timeout=300)


def _steps(path):
    records = read_jsonl(str(path))
    summary = summarize(records)
    assert summary["parse_errors"] == 0
    return records, summary, [e["fields"] for e in summary["events"]
                              if e["name"] == "step"]


def test_losses_bit_for_bit_with_the_tiers_off(tiers):
    _, ranks = tiers
    for r in ranks:
        assert np.array_equal(r["on"], r["off"])
        assert np.all(np.isfinite(r["on"]))
    assert np.array_equal(ranks[0]["on"], ranks[1]["on"])


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_dump_reads_in_the_reference(tiers, rank):
    directory, ranks = tiers
    path = directory / f"metrics.rank{rank}.jsonl"
    assert str(ranks[rank]["path"]) == str(path)
    records, summary, steps = _steps(path)
    assert all(rec.get("process_index") == rank for rec in records)
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert [s["loss"] for s in steps] == list(ranks[rank]["on"])
    for s in steps:
        assert set(STEP_RECORD_FIELDS) <= set(s)
        assert s["reporter"] == "llama_train"
        assert s["process_index"] == rank and s["process_count"] == 2
        assert s["tokens_per_sec"] > 0 and s["mfu"] is None
        assert set(s["phases"]) == {"data", "compute", "comms", "host"}
        assert all(0.0 <= v <= 1.0 for v in s["phases"].values())
        assert s["memory"]["live_bytes"] > 0
    numerics = steps[0]["numerics"]
    assert numerics["step"] == 0 and numerics["finite"]
    assert numerics["tensors"] > 0 and numerics["stats_pass_ms"] >= 0
    assert summary["gauges"]["goodput/ratio"] == pytest.approx(
        float(ranks[rank]["goodput"]))
    names = {e["name"] for e in summary["events"]}
    assert {"attempt_start", "step_done", "numerics_stats",
            "memory_snapshot"} <= names
    assert summary["counters"]["optimizer/fused_adam/dispatch"
                               "{path=tree}"] == 3


def test_launched_ranks_write_their_own_dumps(tmp_path):
    """``multiproc`` exports ``APEX_TPU_PROCESS_INDEX``/``COUNT``: the
    example's ``APEX_TPU_METRICS`` dump lands once a rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo",
               APEX_TPU_METRICS=str(tmp_path / "m.jsonl"))
    for name in ("APEX_TPU_FAULT_PLAN", "APEX_TPU_PROCESS_INDEX",
                 "APEX_TPU_PROCESS_COUNT"):
        env.pop(name, None)
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", "2", "--backend", "gloo", "--cpu",
         str(ROOT / "apex_tpu_torch" / "examples" / "llama_train.py"),
         "--pp", "2", "--dp", "1", "--tp", "1", "--steps", "2",
         "--layers-per-stage", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert sorted(p.name for p in tmp_path.glob("m*.jsonl")) == [
        "m.rank0.jsonl", "m.rank1.jsonl"]
    assert "goodput" in proc.stdout and "m.rank0.jsonl" in proc.stdout
    for r in (0, 1):
        _, _, steps = _steps(tmp_path / f"m.rank{r}.jsonl")
        assert [s["step"] for s in steps] == [0, 1]
