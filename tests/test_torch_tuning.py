"""The port's launch-plan tuner (``apex_tpu_torch.tuning``) on the CPU.

Held against the JAX package's ``apex_tpu.tuning``: the shape buckets are
the same strings for the same dims, and each package refuses the other's
cache file. Port-only: the resolution order (override > tuned > default)
and the clamp of a plan that does not fit, every candidate within the
limits its kernel accepts, the untuned defaults equal to the plans the
wrappers used before tuning, the deterministic roofline ranking,
``tune_all`` writing and merging, a race's verdict recorded and never
applied to dispatch, and ``python -m apex_tpu_torch.tuning``'s exit
codes. Each test has its own ``APEX_TPU_TUNING_CACHE``. The reference's
two flash keys have no search space in the port (one compiled tile a
dtype), so their buckets are not compared.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from apex_tpu.tuning import cache as jcache
from apex_tpu.tuning import search_space as jss
from apex_tpu_torch.ops import kernel_config as kc
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.tuning import __main__ as cli
from apex_tpu_torch.tuning import cache, geometry, measure, search_space
from apex_tpu_torch.tuning import tuner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tuning_env(tmp_path, monkeypatch):
    path = tmp_path / "tuning_cache.json"
    monkeypatch.setenv("APEX_TPU_TUNING_CACHE", str(path))
    cache.clear_memo()
    jcache.clear_memo()
    yield str(path)
    cache.clear_memo()
    jcache.clear_memo()


def _quiet(msg):
    del msg


# ------------------------------------------------------------- buckets

GRID = {
    "flat_adam": [dict(n=n) for n in (1, 7, 1000, 1 << 20, 203716608)],
    "fp8_cast": [dict(n=n) for n in (3, 4096, 58720256)],
    "layer_norm": [dict(rows=r, h=h) for r in (1, 8, 1000, 8192)
                   for h in (64, 1024)],
    "rms_norm": [dict(rows=r, h=4096) for r in (3, 512, 4096, 5000)],
    "fused_softmax": [dict(sk=sk) for sk in (1, 16385, 32768, 100000)],
}


@pytest.mark.parametrize("kernel", sorted(GRID))
def test_shape_bucket_is_the_references_string(kernel):
    assert search_space.KERNELS == tuple(
        k for k in jss.KERNELS if not k.startswith("flash_attention"))
    for dims in GRID[kernel]:
        assert search_space.shape_bucket(kernel, **dims) == \
            jss.shape_bucket(kernel, **dims)
    with pytest.raises(ValueError):
        search_space.shape_bucket("bogus", n=1)


def test_each_package_refuses_the_others_cache(tmp_path):
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jcache.save(jcache.put(jcache.empty(), "cpu", "flat_adam", "n~8",
                           {"params": {"block_rows": 8, "cols": 128}}),
                jpath)
    cache.save(cache.put(cache.empty(), "cpu", "flat_adam", "n~8",
                         {"params": {"threads": 256, "blocks": 1}}), ppath)
    with pytest.raises(ValueError, match="apex_tpu_torch.tuning"):
        cache.load(jpath)
    with pytest.raises(ValueError, match="kind"):
        jcache.load(ppath)
    assert cache.load(ppath)["kind"] == "apex_tpu_torch.tuning"
    assert jcache.load(jpath)["kind"] == "apex_tpu.tuning"


def test_cache_refuses_garbage_and_schema_drift(tuning_env):
    with open(tuning_env, "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="not JSON"):
        cache.load()
    bad = cache.empty()
    bad["schema_version"] = 2
    with open(tuning_env, "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="schema_version 2"):
        cache.load()
    with pytest.raises(ValueError):
        cache.save({"kind": cache.KIND, "schema_version": 1})
    assert cache.cache_path() == tuning_env


# ------------------------------------------------------- candidates


def _norm_plan_ok(p: dict, rows: int, h: int, dtype) -> bool:
    """csrc/norm.cuh ``rows_plan_ok`` for an aligned register-path plan."""
    v = 16 // dtype.itemsize
    t = p["row_threads"]
    return (t >= 32 and t <= ln.MAX_ROW_THREADS and t & (t - 1) == 0
            and p["rows_per_block"] >= 1
            and p["rows_per_block"] * t <= ln.MAX_ROW_THREADS
            and h % v == 0 and h // v <= t * ln.ROW_VECS
            and 1 <= p["blocks"] <= -(-rows // p["rows_per_block"]))


@pytest.mark.parametrize("kernel", ["rms_norm", "layer_norm"])
@pytest.mark.parametrize("rows,h", [(8, 4096), (512, 4096), (4096, 4096),
                                    (8192, 1024), (4096, 768), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_candidates_fit_the_kernel(kernel, rows, h, dtype):
    cands = search_space.candidates(kernel, rows=rows, h=h,
                                    dtype=str(dtype).split(".")[1])
    assert cands and len({json.dumps(c, sort_keys=True)
                          for c in cands}) == len(cands)
    for c in cands:
        assert _norm_plan_ok(c, rows, h, dtype), c
    default = search_space.default_norm_params(rows, h, dtype)
    assert default in cands
    plan = ln._fwd_plan(rows, h, dtype)
    assert default == {"row_threads": plan.row_threads,
                       "rows_per_block": plan.rows_per_block,
                       "blocks": plan.blocks}


@pytest.mark.parametrize("n", [1, 1000, 1 << 20, 203716608])
def test_grid_stride_candidates_fit_their_kernels(n):
    adam = search_space.candidates("flat_adam", n=n)
    assert search_space.default_flat_adam_params(n) in adam
    for c in adam:
        assert c["threads"] in (128, 256, 512, 1024)
        assert 1 <= c["blocks"] <= search_space._flat_adam_want(
            n, c["threads"])
    fp8 = search_space.candidates("fp8_cast", n=n)
    assert search_space.default_fp8_cast_params(n) == \
        {"threads": 256, "blocks_per_sm": 8} and \
        {"threads": 256, "blocks_per_sm": 8} in fp8
    for c in fp8:
        assert c["threads"] % 32 == 0 and c["threads"] <= 1024
        assert 1 <= c["blocks_per_sm"] <= 16
    sm = search_space.candidates("fused_softmax", sk=32768)
    assert {"threads": 256} in sm and all(
        c["threads"] % 32 == 0 and c["threads"] <= 1024 for c in sm)
    # the untuned plans are the kernels' old constants
    assert search_space.default_flat_adam_params(1 << 30) == {
        "threads": 256, "blocks": 4096}


def test_flash_has_no_search_space():
    """The flash kernels run one compiled tile a dtype: no key to sweep,
    bucket or override."""
    for kind in ("fwd", "bwd"):
        with pytest.raises(ValueError, match="unknown kernel"):
            search_space.candidates(f"flash_attention_{kind}", sq=2048,
                                    sk=2048, d=128)
        with pytest.raises(ValueError, match="unknown kernel"):
            search_space.shape_bucket(f"flash_attention_{kind}", sq=2048,
                                      sk=2048, d=128)
        with pytest.raises(ValueError, match="unknown kernel"):
            with geometry.override(f"flash_attention_{kind}", {}):
                pass
        assert f"flash_attention_{kind}" not in tuner.DEFAULT_SHAPES


# ----------------------------------------------------------- geometry


def _put(kernel, dims, params, device_kind="cpu", use_kernel=True):
    c = cache.load()
    cache.put(c, device_kind, kernel, search_space.shape_bucket(kernel,
                                                                **dims),
              {"params": params, "use_kernel": use_kernel})
    cache.save(c)


def test_resolution_order_override_then_tuned_then_default(tuning_env):
    bf16 = torch.bfloat16
    default = ln._fwd_plan(4096, 4096, bf16)
    assert geometry.norm_plan("rms_norm", 4096, 4096, bf16) == default
    assert geometry.source("rms_norm", rows=4096, h=4096) == "default"
    _put("rms_norm", dict(rows=4096, h=4096),
         {"row_threads": 256, "rows_per_block": 1, "blocks": 1056})
    assert geometry.norm_plan("rms_norm", 4096, 4096, bf16) == \
        ln.FwdPlan(256, 1, 1056, True)
    # the same bucket at fewer rows: the blocks clamp to the row groups
    assert geometry.norm_plan("rms_norm", 3000, 4096, bf16) == \
        ln.FwdPlan(256, 1, 1056, True)
    assert geometry.norm_plan("rms_norm", 2100, 4096, bf16).blocks == 1056
    assert geometry.source("rms_norm", rows=4096, h=4096) == "tuned"
    # the backward takes the tuned threads a row, at most DW_PARTS blocks
    assert geometry.norm_bwd_plan("rms_norm", 4096, 4096, bf16) == \
        ln.BwdPlan(256, 1, ln.DW_PARTS, True)
    with geometry.override("rms_norm", {"row_threads": 512,
                                        "rows_per_block": 1,
                                        "blocks": 4096}):
        assert geometry.norm_plan("rms_norm", 4096, 4096, bf16) == \
            ln.FwdPlan(512, 1, 4096, True)
        assert geometry.source("rms_norm", rows=4096, h=4096) == "override"
    assert geometry.norm_plan("rms_norm", 4096, 4096, bf16).row_threads == \
        256
    # another device's entry is never read
    _put("layer_norm", dict(rows=8192, h=1024),
         {"row_threads": 64, "rows_per_block": 4, "blocks": 512},
         device_kind="NVIDIA H100 80GB HBM3")
    assert geometry.norm_plan("layer_norm", 8192, 1024, bf16) == \
        ln._fwd_plan(8192, 1024, bf16)


def test_a_plan_is_looked_up_once_until_refresh(tuning_env, monkeypatch):
    """A launch after the first reads its plan from memory: no cache
    lookup, no environment read; ``kernel_config.refresh_tuning`` forgets
    it, and an override bypasses it."""
    _put("fp8_cast", dict(n=4096), {"threads": 512, "blocks_per_sm": 2})
    looked = []
    lookup = cache.lookup
    monkeypatch.setattr(cache, "lookup",
                        lambda *a, **k: looked.append(a) or lookup(*a, **k))
    assert [geometry.fp8_cast_geometry(4096) for _ in range(3)] == \
        [(512, 2)] * 3
    assert len(looked) == 1
    monkeypatch.setenv("APEX_TPU_TUNING_CACHE", tuning_env + ".other")
    assert geometry.fp8_cast_geometry(4096) == (512, 2)
    kc.refresh_tuning()
    assert geometry.fp8_cast_geometry(4096) == (256, 8)
    assert len(looked) == 2
    with geometry.override("fp8_cast", {"threads": 1024,
                                        "blocks_per_sm": 4}):
        assert geometry.fp8_cast_geometry(4096) == (1024, 4)
    assert geometry.fp8_cast_geometry(4096) == (256, 8)


@pytest.mark.parametrize("bad", [
    {"row_threads": 48, "rows_per_block": 1, "blocks": 4},
    {"row_threads": 64, "rows_per_block": 1, "blocks": 4},   # too few
    {"row_threads": 128, "rows_per_block": 8, "blocks": 4},  # 1024 a block
    {"row_threads": "x"}, {}])
def test_a_plan_that_does_not_fit_clamps_to_the_default(tuning_env, bad):
    bf16 = torch.bfloat16
    with geometry.override("rms_norm", bad):
        assert geometry.norm_plan("rms_norm", 4096, 4096, bf16) == \
            ln._fwd_plan(4096, 4096, bf16)
    with geometry.override("rms_norm", {"row_threads": 128,
                                        "rows_per_block": 2,
                                        "blocks": 64}):
        # a misaligned row or a loop-path width keeps its own plan
        assert geometry.norm_plan("rms_norm", 64, 4096, bf16,
                                  aligned=False) == ln._fwd_plan(
            64, 4096, bf16, aligned=False)
        assert geometry.norm_plan("rms_norm", 64, 100, bf16) == \
            ln._fwd_plan(64, 100, bf16)


def test_grid_stride_geometry_resolution(tuning_env):
    assert geometry.flat_adam_geometry(1 << 20) == (256, 1024)
    assert geometry.fp8_cast_geometry(4096) == (256, 8)
    assert geometry.softmax_threads(32768) == 256
    _put("flat_adam", dict(n=1 << 20), {"threads": 1024, "blocks": 264})
    _put("fp8_cast", dict(n=4096), {"threads": 512, "blocks_per_sm": 2})
    _put("fused_softmax", dict(sk=32768), {"threads": 1024})
    assert geometry.flat_adam_geometry(1 << 20) == (1024, 264)
    assert geometry.fp8_cast_geometry(4096) == (512, 2)
    assert geometry.softmax_threads(30000) == 1024
    for kernel, params in (("flat_adam", {"threads": 96, "blocks": 2}),
                           ("fp8_cast", {"threads": 256,
                                         "blocks_per_sm": 32}),
                           ("fused_softmax", {"threads": 2048})):
        with geometry.override(kernel, params):
            assert geometry.flat_adam_geometry(1 << 20) == (
                (256, 1024) if kernel == "flat_adam" else (1024, 264))
            assert geometry.fp8_cast_geometry(4096) == (
                (256, 8) if kernel == "fp8_cast" else (512, 2))
            assert geometry.softmax_threads(32768) == (
                256 if kernel == "fused_softmax" else 1024)
    with pytest.raises(ValueError):
        with geometry.override("bogus", {}):
            pass


# -------------------------------------------------------------- tuner


def test_roofline_ranking_is_deterministic(tuning_env):
    a = tuner.tune_all(write=False, log=_quiet)
    b = tuner.tune_all(write=False, log=_quiet)
    assert [r["ranking"] for r in a] == [r["ranking"] for r in b]
    assert [r["kernel"] for r in a] == list(search_space.KERNELS)
    for r in a:
        assert "error" not in r
        assert r["entry"]["source"] == "roofline"
        assert r["device_kind"] == "cpu"
        assert r["default_ms"] is not None
        assert r["entry"]["kernel_ms"] <= r["default_ms"]
        assert r["entry"]["use_kernel"] is True
    # the roofline's shape: too few threads cannot draw the bandwidth,
    # and a launch costs its floor
    small = measure.roofline("flat_adam", {"threads": 128, "blocks": 1},
                             {"n": 1 << 24})
    full = measure.roofline("flat_adam", {"threads": 256, "blocks": 4096},
                            {"n": 1 << 24})
    assert small > 10 * full
    assert measure.roofline("rms_norm", {"row_threads": 512,
                                         "rows_per_block": 1, "blocks": 8},
                            {"rows": 8, "h": 4096}) >= measure.LAUNCH_S


def test_tune_all_writes_merges_and_changes_no_dispatch(tuning_env):
    other = cache.put(cache.empty(), "NVIDIA H100 80GB HBM3", "flat_adam",
                      "n~268435456", {"params": {"threads": 256,
                                                 "blocks": 4096},
                                      "use_kernel": False,
                                      "source": "measured"})
    cache.save(other)
    results = tuner.tune_all(kernels=["flat_adam", "rms_norm"], log=_quiet)
    data = cache.load()
    assert set(data["entries"]) == {"cpu", "NVIDIA H100 80GB HBM3"}
    assert set(data["entries"]["cpu"]) == {"flat_adam", "rms_norm"}
    entry = data["entries"]["cpu"]["rms_norm"]["rows~4096,h=4096"]
    assert set(entry) == {"params", "kernel_ms", "plain_ms", "use_kernel",
                          "source", "dims"}
    assert entry["source"] == "roofline"
    assert all(r["cache_path"] == tuning_env for r in results)
    # a verdict is a record: an entry whose race the plain version won
    # still serves its plan, and dispatch never reads it
    _put("rms_norm", dict(rows=64, h=1024),
         {"row_threads": 128, "rows_per_block": 1, "blocks": 64},
         use_kernel=False)
    assert geometry.norm_plan("rms_norm", 64, 1024, torch.bfloat16) == \
        ln.FwdPlan(128, 1, 64, True)
    x = torch.ones(64, 1024)
    assert kc.dispatch("rms_norm", x) == "interpret"
    assert "apply" not in tuner.tune_kernel.__kwdefaults__
    assert "apply" not in tuner.tune_all.__kwdefaults__


def test_a_failing_kernel_is_recorded_and_counted(tuning_env, monkeypatch):
    from apex_tpu_torch.observability import MetricRegistry

    def broken(kernel, params, dims):
        if kernel == "fused_softmax":
            raise RuntimeError("refused")
        return 1e-9

    monkeypatch.setattr(measure, "roofline", broken)
    reg = MetricRegistry()
    results = tuner.tune_all(kernels=["fused_softmax", "fp8_cast"],
                             write=False, registry=reg, log=_quiet)
    assert "error" in results[0] and "error" not in results[1]
    errors = [m for m in reg.metrics() if m.name == "tuning/candidate_error"]
    assert errors and errors[0].value == 4
    names = {m.name for m in reg.metrics()}
    assert {"tuning/race_won_kernel", "tuning/best_kernel_ms",
            "tuning/plain_ms"} <= names
    assert [e["name"] for e in reg.events()] == ["tuning_result"]
    assert cli.main(["--no-write", "--kernel", "fused_softmax"]) == 1


def test_cli_exit_codes_and_export(tuning_env, tmp_path, capsys):
    out = tmp_path / "export.json"
    assert cli.main(["--kernel", "fp8_cast", "--export", str(out)]) == 0
    assert json.loads(out.read_text())["kind"] == "apex_tpu_torch.tuning"
    capsys.readouterr()
    assert cli.main(["--kernel", "rms_norm", "--no-write", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["cache_path"] is None
    (r,) = report["results"]
    assert r["device_kind"] == "cpu" and r["entry"]["source"] == "roofline"
    with pytest.raises(SystemExit):
        cli.main(["--kernel", "bogus"])


def test_module_runs_on_the_cpu(tmp_path):
    """``python -m apex_tpu_torch.tuning --no-write --json`` with no card:
    exit 0, every entry a roofline one keyed "cpu"."""
    env = dict(os.environ, APEX_TPU_TUNING_CACHE=str(tmp_path / "c.json"),
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "apex_tpu_torch.tuning",
                           "--no-write", "--json"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert len(report["results"]) == len(search_space.KERNELS)
    assert all(r["device_kind"] == "cpu"
               and r["entry"]["source"] == "roofline"
               for r in report["results"])
    assert not (tmp_path / "c.json").exists()


def test_norm_plan_sweep_enumerates_through_the_search_space():
    sys.path.insert(0, ROOT)
    try:
        import norm_plan_sweep
    finally:
        sys.path.remove(ROOT)
    assert not hasattr(norm_plan_sweep, "candidates")
    for rows, h, centred in norm_plan_sweep.SHAPES:
        kernel = "layer_norm" if centred else "rms_norm"
        assert norm_plan_sweep.plans(rows, h, centred) == \
            search_space.candidates(kernel, rows=rows, h=h)
