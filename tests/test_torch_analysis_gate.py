"""The port's lint gate on the CPU: ``apex_tpu_torch.analysis`` over its
default paths (``apex_tpu_torch``, ``chip_smoke.py`` and the driver
scripts) and its registered graph-engine targets leaves no new finding
against the committed baseline, which holds at most 10 entries, each
with its reason, and no target fails to trace; every launch-geometry
constant kept as a suppressed mirror equals the CUDA constant it names,
read from ``ops/csrc``; ``chip_smoke.py``'s planted faults (one of each
of the 18 path-engine check ids) each fire once, at their lines, and its
planted graph programs (one of each of the 16 graph-engine ids) each
once; its kernel-node check holds the traced Llama step against a step's
launch counters; and the path engines need only the standard library."""

import ast
import importlib.util
import json
import pathlib
import re
import sys

import pytest

from apex_tpu_torch.analysis import cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANALYSIS = ROOT / "apex_tpu_torch" / "analysis"
CSRC = ROOT / "apex_tpu_torch" / "ops" / "csrc"
ENGINE_MODULES = ("__init__.py", "__main__.py", "ast_checks.py", "cli.py",
                  "concurrency_checks.py", "findings.py")


def test_gate_leaves_no_new_finding():
    stats, errors = {}, {}
    found = cli.run(root=str(ROOT), stats=stats, errors=errors)
    base = cli.findings_mod.load_baseline(cli.BASELINE_PATH)
    fresh = cli.findings_mod.new_findings(found, base)
    assert fresh == [], "\n".join(f.render() for f in fresh)
    assert errors == {}
    assert stats["files"] >= 200
    assert stats["targets"] == 19
    # the gate reads every default path: none is missing
    assert cli._default_paths(str(ROOT)) == list(cli.DEFAULT_PATHS)


def test_baseline_is_small_and_explained():
    data = json.loads(pathlib.Path(cli.BASELINE_PATH).read_text())
    entries = data["grandfathered"]
    assert sum(entries.values()) <= 10
    reasons = data.get("reasons", {})
    assert set(entries) <= set(reasons), "every entry needs its reason"


def _mirrors():
    """(python file, line, name, value, cuda constant, cuda file) for each
    module constant suppressed for hardcoded-tile-size."""
    out = []
    for path in sorted((ROOT / "apex_tpu_torch").rglob("*.py")):
        lines = path.read_text().splitlines()
        for no, line in enumerate(lines, 1):
            if "disable=hardcoded-tile-size" not in line:
                continue
            m = re.match(r"(\w+) = (\d+)\s*#", line)
            assert m, f"{path}:{no}: a suppressed mirror is NAME = int"
            above = " ".join(lines[max(0, no - 3):no - 1])
            named = re.search(r"mirrors (k\w+) of (csrc/[\w.]+)", above)
            assert named, f"{path}:{no}: names no CUDA constant it mirrors"
            out.append((path.relative_to(ROOT), no, m.group(1),
                        int(m.group(2)), named.group(1), named.group(2)))
    return out


def test_suppressed_mirrors_equal_their_cuda_constants():
    mirrors = _mirrors()
    assert {m[2] for m in mirrors} >= {"ROW_BLOCK", "MAX_ROW_THREADS",
                                       "_ROW_BLOCK", "_MAX_ROW_THREADS"}
    for path, no, name, value, const, src in mirrors:
        text = (CSRC / pathlib.Path(src).name).read_text()
        m = re.search(rf"constexpr\s+int\s+{const}\s*=\s*(\d+)\s*;", text)
        assert m, f"{src} defines no constexpr int {const}"
        assert int(m.group(1)) == value, (
            f"{path}:{no} {name} = {value}, but {src} {const} = "
            f"{m.group(1)}")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_analysis", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_planted_faults_each_fire_once(smoke, tmp_path):
    planted = smoke.planted_analysis(tmp_path)
    assert planted["exit"] == 1
    assert planted["named"] == sorted(
        set(cli.ast_checks.AST_CHECKS)
        | set(cli.concurrency_checks.CONCURRENCY_CHECKS))
    assert planted["findings"] == 18


def test_planted_graph_faults_each_fire_once(smoke):
    planted = smoke.planted_graph_analysis()
    path_ids = set(cli.ast_checks.AST_CHECKS) | set(
        cli.concurrency_checks.CONCURRENCY_CHECKS)
    assert planted["named"] == sorted(cli.known_checks() - path_ids)
    assert planted["findings"] == 16


def test_kernel_nodes_check_holds_nodes_against_launches(smoke):
    from apex_tpu_torch.analysis import targets

    nodes = targets.llama_step_kernel_nodes(num_layers=2, seq=256)
    # a real step's counters (phase 6's form: every counter, most at 0)
    launched = dict.fromkeys(smoke.COUNTER_ENTRIES, 0)
    launched.update(flash_attention_fwd=2, flash_attention_bwd_dq=2,
                    flash_attention_bwd_dkv=2, rms_norm_fwd=5,
                    rms_norm_bwd=5, fused_adam=1, fp8_cast_fill=0)
    got = smoke.kernel_nodes_check(nodes, launched)
    assert got["equal"] and got["traced"] == got["launched"]
    launched["rms_norm_fwd"] = 6
    with pytest.raises(AssertionError, match="kernel nodes"):
        smoke.kernel_nodes_check(nodes, launched)


def test_gate_through_the_module_entry(smoke):
    rc, payload = smoke.run_analysis_cli(
        ["--baseline", "apex_tpu_torch/analysis/baseline.json"], cwd=ROOT)
    assert rc == 0 and payload["findings"] == []
    assert len(payload["by_check"]) == len(cli.known_checks()) == 34
    assert payload["targets"] == 19 and payload["target_errors"] == {}


@pytest.mark.parametrize("name", ENGINE_MODULES)
def test_engines_need_only_the_standard_library(name):
    tree = ast.parse((ANALYSIS / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            root = mod.split(".")[0]
            ok = root in sys.stdlib_module_names or root == "__future__" \
                or mod.startswith("apex_tpu_torch.analysis")
            assert ok, f"{name}:{node.lineno} imports {mod}"
