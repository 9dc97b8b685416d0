"""Time ``chip_smoke.py`` checks of two trees (or more) on one GPU, in turns.

    python flash_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...] [--turns N]
        [--checks check_flash,check_flash_bwd,phase_fmha] [--ptxas flash]

Each root is a checkout of this repository (for example a ``git archive``
of the parent commit unpacked into a git-ignored directory). For every
turn (parent, change, change, parent, ...; with more roots, each root in
order and then in reverse; by default two turns a root) a fresh Python
process imports ``chip_smoke.py`` from that root, builds its kernels
there and runs the named check functions (``--checks``, comma-separated;
by default the flash checks and ``phase_fmha``; a name the tree lacks is
left out), each called with the device phase's result. Each process prints one JSON line
with the check results and the ptxas report of the libraries whose name
starts with ``--ptxas``; a summary of every ``ms`` in the results
follows, one line a turn. Compare two versions only inside one such run:
two runs may land on different cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

DEFAULT_CHECKS = "check_flash,check_flash_bwd,phase_fmha"

CHILD = r"""
import importlib.util, json, sys, time
root, checks, ptxas = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
dev = cs.phase_device()
build = cs.phase_build()
out = {"root": root, "device": dev["nvidia_smi"],
       "ptxas": {k: v for k, v in build["ptxas"].items() if k.startswith(ptxas)}}
t0 = time.time()
for name in checks:
    if hasattr(cs, name):
        out[name] = getattr(cs, name)(dev)
out["seconds"] = time.time() - t0
print(json.dumps(out), flush=True)
"""


def times(result, path=""):
    """Every ``ms`` in a check's result, keyed by its path."""
    if isinstance(result, dict):
        found = {}
        if isinstance(result.get("ms"), float):
            found[path or "ms"] = round(result["ms"], 5)
        for key, value in result.items():
            found.update(times(value, f"{path}.{key}" if path else key))
        return found
    if isinstance(result, (list, tuple)):
        found = {}
        for i, value in enumerate(result):
            found.update(times(value, f"{path}[{i}]"))
        return found
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", metavar="ROOT",
                    help="the parent's root, the change's, and any more")
    ap.add_argument("--turns", type=int, default=0,
                    help="processes to run (default: two a root)")
    ap.add_argument("--checks", default=DEFAULT_CHECKS,
                    help="comma-separated chip_smoke check functions")
    ap.add_argument("--ptxas", default="flash",
                    help="report ptxas for libraries starting with this")
    args = ap.parse_args()
    if len(args.roots) < 2:
        ap.error("give at least two roots")
    checks = [c for c in args.checks.split(",") if c]
    order = args.roots + args.roots[::-1]
    results = []
    for i in range(args.turns or len(order)):
        root = order[i % len(order)]
        proc = subprocess.run([sys.executable, "-c", CHILD, root,
                               ",".join(checks), args.ptxas],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    for r in results:
        print(r["root"], json.dumps({c: times(r[c]) for c in checks
                                     if c in r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
