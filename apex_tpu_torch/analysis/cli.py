"""``python -m apex_tpu_torch.analysis`` — run the AST and concurrency
engines over the port, and the graph engines over its registered targets.

    python -m apex_tpu_torch.analysis                  # default paths
    python -m apex_tpu_torch.analysis apex_tpu_torch/ops chip_smoke.py
    python -m apex_tpu_torch.analysis --no-jaxpr       # path engines only
    python -m apex_tpu_torch.analysis --allow my_target:master-weights
    python -m apex_tpu_torch.analysis --list-targets   # targets + engine
    python -m apex_tpu_torch.analysis --baseline B     # B: the gate's file,
    python -m apex_tpu_torch.analysis --write-baseline B  # baseline.json here
    python -m apex_tpu_torch.analysis --json > base.json  # on the base rev
    python -m apex_tpu_torch.analysis --diff base.json    # fail only on NEW
    python -m apex_tpu_torch.analysis --list-checks
    python -m apex_tpu_torch.analysis --engines concurrency  # engine subset
    python -m apex_tpu_torch.analysis --sarif out.sarif

Exit codes: 0 clean (or all findings grandfathered), 1 new findings,
2 a usage error (unknown check id, engine or target, missing path, a bad
``--diff`` base), a registered target that failed to trace, or an
exceeded wall-time budget. The tracing engines (``jaxpr``: the graph
checks, ``dataflow``: precision, ``state``, ``serving``) run the
targets of :mod:`.targets` (fake tensors, no device work); the
reference's sharding, spmd and memory engines and its ``plan``
subcommand are not ported yet.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

from apex_tpu_torch.analysis import ast_checks, concurrency_checks, targets
from apex_tpu_torch.analysis import findings as findings_mod
from apex_tpu_torch.analysis.graph_checks import GRAPH_CHECKS
from apex_tpu_torch.analysis.precision_checks import PRECISION_CHECKS
from apex_tpu_torch.analysis.state_checks import STATE_CHECKS

# The port, its driver scripts and chip_smoke.py (which the reference's
# tools/ and bench.py correspond to: driver code).
DEFAULT_PATHS = ("apex_tpu_torch", "chip_smoke.py", "flash_ab.py",
                 "serving_ab.py", "norm_plan_sweep.py", "ckpt_write_ab.py")

# The port's gate: its grandfathered findings (the reference's format).
BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

# The engines --engines selects from, and the per-engine wall-time line.
ENGINE_NAMES = ("ast", "concurrency", "jaxpr", "dataflow", "state",
                "serving")

# the engines that run the registered targets
_TRACING_ENGINES = frozenset(ENGINE_NAMES) - {"ast", "concurrency"}

# Total-wall-time budget for one gate run: a silently-slowing gate rots
# the suite's latency. Override with LINT_TIME_BUDGET_S, or set it <= 0
# to disable.
DEFAULT_TIME_BUDGET_S = 180.0

# The --json payload: its kind names this package, so each package's
# --diff refuses the other's dump (their check vocabularies differ).
# Version 1 payloads carry a per-finding "fingerprint" (check+symbol+
# snippet hash, see findings.finding_fingerprint) that --diff uses to
# survive file renames/moves.
JSON_KIND = "apex_tpu_torch.analysis"
JSON_SCHEMA_VERSION = 1


def _default_paths(root):
    return [p for p in DEFAULT_PATHS if os.path.exists(
        os.path.join(root, p))]


def known_checks():
    return (set(ast_checks.AST_CHECKS)
            | set(concurrency_checks.CONCURRENCY_CHECKS)
            | set(GRAPH_CHECKS) | set(PRECISION_CHECKS) | set(STATE_CHECKS)
            | set(targets.TARGET_CHECKS))


def target_engine(target_name) -> str:
    """The engine a registered target's wall time and findings fall
    under."""
    return ("serving" if target_name in targets.SERVING_TARGETS else
            "dataflow" if target_name in targets.PRECISION_TARGETS else
            "state" if target_name in targets.STATE_TARGETS else "jaxpr")


def parse_engines(spec):
    """--engines value -> validated frozenset of engine names; loud on
    typos and on an empty selection (either would silently run
    nothing/everything forever)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = [e.strip() for e in spec.split(",") if e.strip()]
    engines = frozenset(spec)
    if not engines:
        raise ValueError(
            f"--engines selected no engine; valid: {list(ENGINE_NAMES)}")
    unknown = engines - set(ENGINE_NAMES)
    if unknown:
        raise ValueError(
            f"unknown engine(s) {sorted(unknown)}; valid: "
            f"{list(ENGINE_NAMES)}")
    return engines


def load_diff_report(path):
    """A stored ``--json`` dump -> (Counter of finding keys, Counter of
    snippet fingerprints) — the --diff base. Loud on anything that is
    not this package's report of a schema this reader knows — a
    silently-ignored base would report every finding as old forever."""
    with open(path) as f:
        try:
            data = json.load(f)
        except ValueError as e:
            raise ValueError(f"--diff base {path} is not JSON: {e}")
    kind = data.get("kind") if isinstance(data, dict) else None
    if kind != JSON_KIND:
        raise ValueError(
            f"--diff base {path} is not an {JSON_KIND} --json dump "
            f"(kind {kind!r})")
    version = data.get("schema_version")
    if version not in (JSON_SCHEMA_VERSION,):
        raise ValueError(
            f"--diff base {path} has schema_version {version}; this "
            f"reader knows [{JSON_SCHEMA_VERSION}]")
    keys = collections.Counter()
    fps = collections.Counter()
    for f in data.get("findings", ()):
        keys[f"{f.get('check')}:{f.get('path')}:{f.get('symbol')}"] += 1
        if f.get("fingerprint"):
            fps[f["fingerprint"]] += 1
    return keys, fps


def parse_allow(entries):
    """['target:check', ...] -> {target: {check, ...}}; loud on a typo (an
    allow matching nothing would silently stop allowing) and on a check
    no target can emit."""
    target_checks = set(targets.TRACING_CHECKS) | set(targets.TARGET_CHECKS)
    allow: dict = {}
    for entry in entries or ():
        target_name, sep, check = entry.partition(":")
        if not sep or not target_name or not check:
            raise ValueError(f"--allow expects target:check, got {entry!r}")
        if target_name not in targets.TARGETS:
            raise ValueError(
                f"--allow names unknown target {target_name!r}; valid: "
                f"{sorted(targets.TARGETS)}")
        if check not in target_checks:
            raise ValueError(
                f"--allow names check id {check!r} that no target can "
                f"emit; valid: {sorted(target_checks)}")
        allow.setdefault(target_name, set()).add(check)
    return allow


def run(paths=None, root=None, ast=True, concurrency=True, checks=None,
        engine_seconds=None, engines=None, stats=None, jaxpr=True,
        allow=None, errors=None):
    """Programmatic entry: returns the findings.

    ``engine_seconds``: an optional dict that receives per-engine wall
    time (keys :data:`ENGINE_NAMES`). The concurrency engine shares the
    AST engine's path list. ``engines``: an iterable of
    :data:`ENGINE_NAMES` to restrict the run to (validated loudly);
    composes with the ``--no-*`` flags (both must select an engine) and
    with ``checks`` (intersection). ``stats``: an optional dict that
    receives ``files`` (the .py files linted), ``suppressed`` (a
    Counter of the findings inline comments silenced, by check) and
    ``targets`` (the registered targets run). ``jaxpr``: run the
    registered targets (the tracing engines); ``allow``: {target: check
    ids} dropped from that target; ``errors``: a dict that receives each
    target that failed to trace, with its error.
    """
    engines = parse_engines(engines)
    if engines is not None:
        ast = ast and "ast" in engines
        concurrency = concurrency and "concurrency" in engines
    if checks:
        unknown = set(checks) - known_checks()
        if unknown:
            # a typo'd id silently matching nothing would report a clean
            # run forever — fail loudly instead
            raise ValueError(
                f"unknown check id(s): {sorted(unknown)}; valid: "
                f"{sorted(known_checks())}")
    root = os.path.abspath(root or os.getcwd())
    use = [os.path.join(root, p) if not os.path.isabs(p) else p
           for p in (paths or _default_paths(root))]
    if paths:
        # a typo'd path yielding zero files would report a clean run
        # forever — same failure mode as a typo'd check id
        missing = [p for p in use if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"lint path(s) do not exist: {missing}")
    silenced: list = []
    all_findings = []
    for name, on, engine, ids in (
            ("ast", ast, ast_checks, ast_checks.AST_CHECKS),
            ("concurrency", concurrency, concurrency_checks,
             concurrency_checks.CONCURRENCY_CHECKS)):
        wanted = set(checks) & set(ids) if checks else None
        if not on or wanted == set():
            continue
        # the engines' wall time is host work, with no device in it
        t0 = time.perf_counter()  # apex-lint: disable=raw-clock
        all_findings += engine.lint_paths(use, root=root, checks=wanted,
                                          suppressed=silenced)
        if engine_seconds is not None:
            engine_seconds[name] = (
                engine_seconds.get(name, 0.0)
                + time.perf_counter() - t0)  # apex-lint: disable=raw-clock
    ran = _run_targets(jaxpr, checks, engines, allow, engine_seconds,
                       all_findings, errors)
    if stats is not None:
        stats["files"] = sum(1 for _ in ast_checks.iter_python_files(use))
        stats["suppressed"] = collections.Counter(f.check for f in silenced)
        stats["targets"] = ran
    return all_findings


def _run_targets(jaxpr, checks, engines, allow, engine_seconds, out,
                 errors) -> int:
    """Run the registered targets the selection asks for, adding their
    findings to ``out``; returns how many ran."""
    if not jaxpr:
        return 0
    if checks is None or set(checks) & set(targets.TRACING_CHECKS):
        names = set(targets.TARGETS)
    else:
        # only the non-tracing targets whose checks were asked for
        names = set(targets.TARGETS) & set(checks)
    if engines is not None:
        tracing = engines & _TRACING_ENGINES
        names = {n for n in names if target_engine(n) in tracing}
    if not names:
        return 0
    per_target: dict = {}
    found, failed = targets.run_targets(names, extra_allow=allow,
                                        timings=per_target)
    if engine_seconds is not None:
        for name, seconds in per_target.items():
            engine = target_engine(name)
            engine_seconds[engine] = engine_seconds.get(engine, 0.0) \
                + seconds
    if checks:
        found = [f for f in found if f.check in checks]
    out += found
    if errors is not None:
        errors.update(failed)
    return len(names)


def sarif_report(findings, root=None) -> dict:
    """Findings -> a SARIF 2.1.0 ``run`` document: one reporting rule per
    known check id (stable, sorted — present even at 0 results), one
    result per finding, snippet fingerprints in ``partialFingerprints``.
    Deterministic on purpose: no clocks, sorted rule table, results in
    the CLI's sorted finding order — re-exporting the same run yields a
    byte-identical file."""
    rule_ids = sorted(known_checks())
    rule_index = {cid: i for i, cid in enumerate(rule_ids)}
    lines_cache: dict = {}
    results = []
    for f in findings:
        result = {
            "ruleId": f.check,
            "ruleIndex": rule_index.get(f.check, -1),
            "level": f.severity if f.severity in ("error", "warning")
            else "warning",
            "message": {"text": f.message},
        }
        if f.line > 0:
            result["locations"] = [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/")},
                    "region": {"startLine": f.line},
                },
            }]
        else:
            # a graph finding (``<graph:target>``) has no file region
            result["locations"] = [{
                "logicalLocations": [{
                    "name": f.symbol,
                    "fullyQualifiedName": f"{f.path}:{f.symbol}",
                }],
            }]
        fp = findings_mod.finding_fingerprint(f, root=root,
                                              lines_cache=lines_cache)
        if fp:
            result["partialFingerprints"] = {
                "apexTpuTorchFingerprint/v1": fp}
        results.append(result)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": JSON_KIND,
                "rules": [{"id": cid} for cid in rule_ids],
            }},
            "results": results,
        }],
    }


def write_sarif(path, findings, root=None):
    with open(path, "w") as f:
        f.write(json.dumps(sarif_report(findings, root=root),
                           indent=2, sort_keys=True) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.analysis",
        description="apex_tpu_torch static lint (AST, host-concurrency "
                    "and graph engines)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="repo root findings are reported relative to "
                         "(default: cwd)")
    ap.add_argument("--no-ast", dest="ast", action="store_false")
    ap.add_argument("--no-jaxpr", dest="jaxpr", action="store_false",
                    help="skip the registered targets (the graph, "
                         "precision, state and serving engines)")
    ap.add_argument("--no-concurrency", dest="concurrency",
                    action="store_false",
                    help="skip the host-concurrency engine (it shares "
                         "the AST engine's path list)")
    ap.add_argument("--checks", default=None,
                    help="comma-separated check ids to run")
    ap.add_argument("--engines", default=None,
                    help=f"comma-separated engine subset to run "
                         f"(valid: {','.join(ENGINE_NAMES)}); composes "
                         f"with --checks")
    ap.add_argument("--allow", action="append", default=[],
                    metavar="TARGET:CHECK",
                    help="drop findings of CHECK from TARGET (repeatable): "
                         "a per-target grandfather for a deliberate "
                         "violation")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of grandfathered findings; only "
                         "NEW findings fail the run")
    ap.add_argument("--diff", default=None, metavar="REPORT.json",
                    help="a stored --json dump to diff against: only "
                         "findings not in that run fail (composes with "
                         "--baseline)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current findings as the baseline and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--sarif", default=None, metavar="OUT.json",
                    help="also write the (post-baseline) findings as a "
                         "SARIF 2.1.0 report — one rule per check id, "
                         "snippet fingerprints as partialFingerprints; "
                         "byte-stable across identical runs")
    ap.add_argument("--list-checks", action="store_true")
    ap.add_argument("--list-targets", action="store_true",
                    help="print the registered targets and the engine "
                         "each falls under, then exit")
    args = ap.parse_args(argv)

    if args.list_checks:
        for cid in ast_checks.AST_CHECKS:
            print(f"{cid:32s} [ast]")
        for cid in concurrency_checks.CONCURRENCY_CHECKS:
            print(f"{cid:32s} [concurrency]")
        for cid in GRAPH_CHECKS:
            print(f"{cid:32s} [jaxpr]")
        for cid in PRECISION_CHECKS:
            print(f"{cid:32s} [jaxpr/dataflow]")
        for cid in STATE_CHECKS:
            print(f"{cid:32s} [jaxpr/state]")
        for cid in targets.TARGET_CHECKS:
            print(f"{cid:32s} [jaxpr]")
        return 0

    if args.list_targets:
        for name in targets.TARGETS:
            print(f"{name:36s} [{target_engine(name)}]")
        return 0

    checks = None
    if args.checks:
        checks = {c.strip() for c in args.checks.split(",") if c.strip()}

    engine_seconds: dict = {}
    stats: dict = {}
    errors: dict = {}
    try:
        allow = parse_allow(args.allow)
        # validate the diff base BEFORE the run: a bad base should fail
        # in milliseconds, not after tracing every target
        diff_keys = diff_fps = None
        if args.diff:
            diff_keys, diff_fps = load_diff_report(args.diff)
        found = run(paths=args.paths or None, root=args.root,
                    ast=args.ast, concurrency=args.concurrency,
                    checks=checks, engine_seconds=engine_seconds,
                    engines=args.engines, stats=stats, jaxpr=args.jaxpr,
                    allow=allow, errors=errors)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    found.sort(key=lambda f: (f.path, f.line, f.check))

    for name, err in sorted(errors.items()):
        print(f"TARGET ERROR {name}: {err}", file=sys.stderr)

    if args.write_baseline:
        findings_mod.save_baseline(args.write_baseline, found)
        print(f"wrote {len(found)} grandfathered finding(s) to "
              f"{args.write_baseline}")
        return 2 if errors else 0

    fresh = found
    grandfathered = 0
    base_keys = None
    if args.baseline:
        try:
            base_keys = findings_mod.load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"--baseline {args.baseline}: {e}", file=sys.stderr)
            return 2
    if diff_keys is not None:
        # per-key MAX, not sum: a finding present in both bases must
        # not double its grandfather budget
        base_keys = diff_keys if base_keys is None \
            else base_keys | diff_keys
    if base_keys is not None:
        # the diff base's snippet fingerprints give renamed/moved files
        # a second chance: same check+symbol+source line under a new
        # path is churn, not a NEW finding
        fresh = findings_mod.new_findings_with_fingerprints(
            found, base_keys, diff_fps, root=args.root)
        grandfathered = len(found) - len(fresh)

    if args.sarif:
        write_sarif(args.sarif, fresh, root=args.root)
        print(f"sarif -> {args.sarif}", file=sys.stderr)

    timing = "  ".join(
        f"{name} {engine_seconds.get(name, 0.0):.1f}s"
        for name in ENGINE_NAMES)
    total = sum(engine_seconds.values())
    over_budget = _check_time_budget(total)
    if args.json:
        lines_cache: dict = {}
        by_check = collections.Counter(f.check for f in found)
        print(json.dumps({
            "schema_version": JSON_SCHEMA_VERSION,
            "kind": JSON_KIND,
            "findings": [
                dict(vars(f),
                     fingerprint=findings_mod.finding_fingerprint(
                         f, root=args.root, lines_cache=lines_cache))
                for f in fresh],
            "grandfathered": grandfathered,
            "files": stats.get("files", 0),
            "by_check": {cid: by_check.get(cid, 0)
                         for cid in sorted(known_checks())},
            "suppressed": dict(sorted(
                stats.get("suppressed", {}).items())),
            "targets": stats.get("targets", 0),
            "target_errors": errors,
            "engine_seconds": {k: round(v, 3) for k, v in
                               sorted(engine_seconds.items())},
        }, indent=2))
        print(f"engine wall time: {timing}  (total {total:.1f}s)",
              file=sys.stderr)
    else:
        for f in fresh:
            print(f.render())
        tail = f" ({grandfathered} grandfathered)" \
            if base_keys is not None else ""
        print(f"{len(fresh)} finding(s){tail}", file=sys.stderr)
        print(f"engine wall time: {timing}  (total {total:.1f}s)",
              file=sys.stderr)

    if errors or over_budget:
        return 2
    return 1 if fresh else 0


def _check_time_budget(total_seconds) -> bool:
    """The gate's wall time is itself gated. True (and a LOUD stderr
    report) when the summed engine_seconds exceed LINT_TIME_BUDGET_S
    (default :data:`DEFAULT_TIME_BUDGET_S`; <= 0 disables). A malformed
    override is an error, not a silent default — a typo'd budget would
    never fire again."""
    raw = os.environ.get("LINT_TIME_BUDGET_S", "")
    if raw.strip():
        try:
            budget = float(raw)
        except ValueError:
            print(f"LINT_TIME_BUDGET_S={raw!r} is not a number",
                  file=sys.stderr)
            return True
    else:
        budget = DEFAULT_TIME_BUDGET_S
    if budget <= 0 or total_seconds <= budget:
        return False
    print(f"LINT TIME BUDGET EXCEEDED: engines took "
          f"{total_seconds:.1f}s > {budget:.1f}s "
          f"(LINT_TIME_BUDGET_S) — profile the per-engine wall-time "
          f"line above and trim the offending paths (or raise the "
          f"budget deliberately)", file=sys.stderr)
    return True
