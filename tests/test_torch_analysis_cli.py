"""``apex_tpu_torch.analysis``'s findings model and CLI on the CPU:
suppressions, baselines and fingerprints read the same in both packages,
each package's ``--diff`` refuses the other's dump, and the CLI end to
end in a temporary tree (exit codes 0, 1 and 2, ``--checks`` and
``--engines``, ``--write-baseline`` then ``--baseline``, the JSON and
SARIF payloads, the wall-time budget, the graph engines' ``--no-jaxpr``,
``--allow`` and ``--list-targets``, and the planner's ``plan`` still
refused). In the temporary tree the registered targets are cut to one
cheap target of each tracing engine."""

import collections
import json
import os
import subprocess
import sys

import pytest

from apex_tpu.analysis import cli as ref_cli
from apex_tpu.analysis import findings as ref_findings
from apex_tpu_torch.analysis import cli
from apex_tpu_torch.analysis import findings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = """\
x = 1  # apex-lint: disable=sync-timing
# apex-lint: disable=raw-clock, host-in-jit
y = 2
z = 3  # apex-lint: disable
w = 4  # apex-lint: disable=raw-clock
v = 5
# plain comment
u = 6
"""

VIOLATION = """\
import time


def elapsed(start):
    return time.perf_counter() - start
"""


def test_suppressions_read_the_same_in_both_packages():
    lines = SOURCE.splitlines()
    for no in range(1, len(lines) + 2):
        assert findings.suppressed_checks(lines, no) == \
            ref_findings.suppressed_checks(lines, no)
    assert findings.suppressed_checks(lines, 3) == {"raw-clock",
                                                    "host-in-jit"}
    assert findings.suppressed_checks(lines, 4) == set()
    # a trailing comment on the line above suppresses that line only
    assert findings.suppressed_checks(lines, 6) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baselines_cross_load(tmp_path, writer):
    found = [findings.Finding("raw-clock", "error", "apex_tpu_torch/a.py",
                              3, "f", "m"),
             findings.Finding("raw-clock", "error", "apex_tpu_torch/a.py",
                              9, "f", "m"),
             findings.Finding("unclosed-span", "error", "chip_smoke.py", 1,
                              "<module>", "m")]
    path = tmp_path / "baseline.json"
    (findings if writer == "port" else ref_findings).save_baseline(
        path, found)
    want = collections.Counter({"raw-clock:apex_tpu_torch/a.py:f": 2,
                                "unclosed-span:chip_smoke.py:<module>": 1})
    assert findings.load_baseline(path) == want
    assert ref_findings.load_baseline(path) == want
    fresh = findings.new_findings(found + found[:1], want)
    assert fresh == ref_findings.new_findings(found + found[:1], want)
    assert [f.line for f in fresh] == [3]


def test_fingerprints_are_the_same_in_both_packages(tmp_path):
    (tmp_path / "a.py").write_text(VIOLATION)
    (tmp_path / "b.py").write_text(VIOLATION)
    args = ("raw-clock", "error", "a.py", 5, "elapsed", "m")
    port_f, ref_f = findings.Finding(*args), ref_findings.Finding(*args)
    fp = findings.finding_fingerprint(port_f, root=str(tmp_path))
    assert fp and fp == ref_findings.finding_fingerprint(
        ref_f, root=str(tmp_path))
    # a moved file keeps its fingerprint: the rename is not a new finding
    moved = findings.Finding("raw-clock", "error", "b.py", 5, "elapsed",
                             "m")
    base_fps = collections.Counter({fp: 1})
    assert findings.new_findings_with_fingerprints(
        [moved], collections.Counter(), base_fps,
        root=str(tmp_path)) == []
    assert ref_findings.new_findings_with_fingerprints(
        [ref_findings.Finding(*moved.__dict__.values())],
        collections.Counter(), base_fps, root=str(tmp_path)) == []
    # one more copy than the base had is new, in both
    assert len(findings.new_findings_with_fingerprints(
        [port_f, moved], collections.Counter(), base_fps,
        root=str(tmp_path))) == 1


def test_each_diff_refuses_the_other_packages_dump(tmp_path):
    ref_dump = tmp_path / "ref.json"
    ref_dump.write_text(json.dumps({
        "schema_version": ref_cli.JSON_SCHEMA_VERSION,
        "kind": "apex_tpu.analysis", "findings": []}))
    port_dump = tmp_path / "port.json"
    port_dump.write_text(json.dumps({
        "schema_version": cli.JSON_SCHEMA_VERSION, "kind": cli.JSON_KIND,
        "findings": []}))
    assert cli.load_diff_report(str(port_dump)) == (collections.Counter(),
                                                    collections.Counter())
    with pytest.raises(ValueError, match="apex_tpu_torch.analysis"):
        cli.load_diff_report(str(ref_dump))
    with pytest.raises(ValueError, match="apex_tpu.analysis"):
        ref_cli.load_diff_report(str(port_dump))
    ref_cli.load_diff_report(str(ref_dump))
    assert cli.main(["--diff", str(ref_dump), "--root", str(tmp_path),
                     str(tmp_path)]) == 2


# one cheap registered target of each tracing engine
TREE_TARGETS = ("step-record-schema", "tp_fused_softmax",
                "state_resilient_resume_path", "state_serving_decode_step")
N_CHECKS = 18 + 3 + 7 + 5 + 1


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A checkout-shaped tree: one library module with a raw clock, one
    clean example; the registered targets cut to :data:`TREE_TARGETS`."""
    from apex_tpu_torch.analysis import targets

    monkeypatch.setattr(targets, "TARGETS", {
        k: v for k, v in targets.TARGETS.items() if k in TREE_TARGETS})
    lib = tmp_path / "apex_tpu_torch" / "runtime"
    lib.mkdir(parents=True)
    (lib / "clock.py").write_text(VIOLATION)
    ex = tmp_path / "apex_tpu_torch" / "examples"
    ex.mkdir()
    (ex / "drive.py").write_text(VIOLATION)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LINT_TIME_BUDGET_S", raising=False)
    return tmp_path


def _json(capsys, argv):
    rc = cli.main(["--json", *argv])
    return rc, json.loads(capsys.readouterr().out)


def test_fresh_violation_exits_1_and_names_the_check(tree, capsys):
    rc = cli.main([])
    out = capsys.readouterr()
    assert rc == 1
    # the library's clock is a finding; the example's is driver code
    (line,) = out.out.splitlines()
    assert line.startswith(
        "apex_tpu_torch/runtime/clock.py:5: [error] raw-clock: ")
    assert "1 finding(s)" in out.err and "engine wall time" in out.err


def test_checks_and_engines_narrow_the_run(tree, capsys):
    assert cli.main(["--checks", "mutable-default"]) == 0
    assert cli.main(["--engines", "concurrency"]) == 0
    assert cli.main(["--no-concurrency", "--checks", "raw-clock"]) == 1
    assert cli.main(["--no-ast", "--engines", "ast"]) == 0
    capsys.readouterr()
    for argv, needle in ((["--checks", "raw-clok"], "unknown check"),
                         (["--engines", "sharding"], "unknown engine"),
                         (["--engines", ","], "no engine"),
                         (["no/such/dir"], "do not exist")):
        assert cli.main(argv) == 2
        assert needle in capsys.readouterr().err


def test_write_baseline_then_baseline_gives_0(tree, capsys):
    base = tree / "baseline.json"
    assert cli.main(["--write-baseline", str(base)]) == 0
    assert json.loads(base.read_text())["grandfathered"] == {
        "raw-clock:apex_tpu_torch/runtime/clock.py:elapsed": 1}
    assert cli.main(["--baseline", str(base)]) == 0
    assert "(1 grandfathered)" in capsys.readouterr().err
    # a second occurrence is new
    (tree / "apex_tpu_torch" / "runtime" / "clock.py").write_text(
        VIOLATION + "\n\ndef again(start):\n"
        "    return time.perf_counter() - start\n")
    assert cli.main(["--baseline", str(base)]) == 1


def test_json_payload(tree, capsys):
    rc, data = _json(capsys, [])
    assert rc == 1
    assert data["kind"] == "apex_tpu_torch.analysis"
    assert data["schema_version"] == 1
    assert data["files"] == 2 and data["grandfathered"] == 0
    assert set(data["by_check"]) == cli.known_checks()
    assert len(data["by_check"]) == N_CHECKS
    assert data["targets"] == len(TREE_TARGETS)
    assert data["target_errors"] == {}
    assert data["by_check"]["raw-clock"] == 1
    assert sum(data["by_check"].values()) == 1
    assert set(data["engine_seconds"]) == set(cli.ENGINE_NAMES)
    (f,) = data["findings"]
    assert {k: f[k] for k in ("check", "path", "line", "symbol")} == {
        "check": "raw-clock", "path": "apex_tpu_torch/runtime/clock.py",
        "line": 5, "symbol": "elapsed"}
    assert len(f["fingerprint"]) == 16
    # suppressed inline: counted as such, not as a finding
    (tree / "apex_tpu_torch" / "runtime" / "clock.py").write_text(
        VIOLATION.replace("start\n",
                          "start  # apex-lint: disable=raw-clock\n"))
    rc, data = _json(capsys, [])
    assert rc == 0 and data["findings"] == []
    assert data["suppressed"] == {"raw-clock": 1}


def test_diff_survives_a_rename(tree, capsys):
    rc, data = _json(capsys, [])
    base = tree / "base.json"
    base.write_text(json.dumps(data))
    lib = tree / "apex_tpu_torch" / "runtime"
    os.rename(lib / "clock.py", lib / "clock2.py")
    assert cli.main(["--diff", str(base)]) == 0
    stripped = dict(data, findings=[
        {k: v for k, v in f.items() if k != "fingerprint"}
        for f in data["findings"]])
    base.write_text(json.dumps(stripped))
    assert cli.main(["--diff", str(base)]) == 1


def test_sarif_payload(tree, capsys):
    a, b = tree / "a.sarif", tree / "b.sarif"
    assert cli.main(["--sarif", str(a)]) == 1
    assert cli.main(["--sarif", str(b)]) == 1
    assert a.read_bytes() == b.read_bytes()
    doc = json.loads(a.read_text())
    assert doc["version"] == "2.1.0"
    (run,) = doc["runs"]
    rules = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert rules == sorted(cli.known_checks()) and len(rules) == N_CHECKS
    assert run["tool"]["driver"]["name"] == "apex_tpu_torch.analysis"
    (res,) = run["results"]
    assert res["ruleId"] == "raw-clock"
    assert rules[res["ruleIndex"]] == "raw-clock"
    loc = res["locations"][0]["physicalLocation"]
    assert loc == {"artifactLocation": {
        "uri": "apex_tpu_torch/runtime/clock.py"}, "region": {"startLine": 5}}
    assert len(res["partialFingerprints"][
        "apexTpuTorchFingerprint/v1"]) == 16


def test_exceeded_budget_exits_2(tree, capsys, monkeypatch):
    monkeypatch.setenv("LINT_TIME_BUDGET_S", "0.0000001")
    assert cli.main(["--checks", "mutable-default"]) == 2
    assert "LINT TIME BUDGET EXCEEDED" in capsys.readouterr().err
    monkeypatch.setenv("LINT_TIME_BUDGET_S", "soon")
    assert cli.main(["--checks", "mutable-default"]) == 2
    monkeypatch.setenv("LINT_TIME_BUDGET_S", "0")
    assert cli.main(["--checks", "mutable-default"]) == 0


@pytest.mark.parametrize("argv", [["plan"], ["plan", "--target", "llama"]])
def test_later_engines_flags_are_refused(tree, capsys, argv):
    """The planner (``plan``) is not ported yet."""
    # a positional `plan` is a path: it does not exist here
    assert cli.main(argv[:1]) == 2
    if len(argv) == 1:
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--no-jaxpr", "--allow", "--list-targets"])
def test_graph_engine_flags(tree, capsys, monkeypatch, flag):
    if flag == "--no-jaxpr":
        rc, data = _json(capsys, ["--no-jaxpr"])
        assert rc == 1 and data["targets"] == 0
        assert set(data["engine_seconds"]) == {"ast", "concurrency"}
        rc, data = _json(capsys, [])
        assert data["targets"] == len(TREE_TARGETS)
        assert set(data["engine_seconds"]) == set(cli.ENGINE_NAMES)
    elif flag == "--allow":
        from apex_tpu_torch.observability import step_report

        monkeypatch.setattr(step_report, "STEP_RECORD_FIELDS",
                            step_report.STEP_RECORD_FIELDS + ("gone",))
        rc, data = _json(capsys, ["--checks", "step-record-schema"])
        assert rc == 1 and [f["check"] for f in data["findings"]] == [
            "step-record-schema"]
        rc, data = _json(capsys, ["--checks", "step-record-schema",
                                  "--allow",
                                  "step-record-schema:step-record-schema"])
        assert rc == 0 and data["findings"] == []
        for bad, needle in (("nope:donation", "unknown target"),
                            ("tp_fused_softmax:raw-clock", "no target"),
                            ("tp_fused_softmax", "target:check")):
            assert cli.main(["--allow", bad]) == 2
            assert needle in capsys.readouterr().err
    else:
        assert cli.main(["--list-targets"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert [ln.split() for ln in lines] == [
            ["step-record-schema", "[jaxpr]"],
            ["tp_fused_softmax", "[dataflow]"],
            ["state_resilient_resume_path", "[state]"],
            ["state_serving_decode_step", "[serving]"]]


def test_list_checks_and_module_entry(tree):
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.analysis", "--list-checks"],
        capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT)).stdout.splitlines()
    assert len(out) == N_CHECKS
    assert [ln.split()[0] for ln in out] == [
        *cli.ast_checks.AST_CHECKS,
        *cli.concurrency_checks.CONCURRENCY_CHECKS, *cli.GRAPH_CHECKS,
        *cli.PRECISION_CHECKS, *cli.STATE_CHECKS, "step-record-schema"]
    assert cli.ENGINE_NAMES == ("ast", "concurrency", "jaxpr", "dataflow",
                                "state", "serving")
