"""Time the flash-attention kernels of two trees on one GPU, in turns.

    python flash_ab.py PARENT_ROOT CHANGE_ROOT [--turns 4]

Each root is a checkout of this repository (for example a ``git archive``
of the parent commit unpacked into a git-ignored directory). For every
turn (parent, change, change, parent, ...) a fresh Python process imports
``chip_smoke.py`` from that root, builds its kernels there and runs its
``check_flash`` and ``check_flash_bwd`` (and ``phase_fmha`` where the
tree has it); each process prints one JSON line, and a summary of the
device ms follows. Compare two versions only inside one such run: two
runs may land on different cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import importlib.util, json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
dev = cs.phase_device()
build = cs.phase_build()
out = {"root": root, "device": dev["nvidia_smi"],
       "ptxas": {k: v for k, v in build["ptxas"].items() if k.startswith("flash")}}
t0 = time.time()
out["fwd"] = cs.check_flash(dev)
out["bwd"] = cs.check_flash_bwd(dev)
if hasattr(cs, "phase_fmha"):
    out["fmha"] = cs.phase_fmha(dev)
out["seconds"] = time.time() - t0
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    order = [args.parent, args.change, args.change, args.parent]
    results = []
    for i in range(args.turns):
        root = order[i % 4]
        proc = subprocess.run([sys.executable, "-c", CHILD, root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    for r in results:
        fwd = {r_.get("case") or "x".join(map(str, r_["shape"][:2])):
               round(r_["ms"], 4) for r_ in r["fwd"]}
        bwd = r["bwd"]
        print(r["root"], "fwd", fwd, "dq", round(bwd["dq"]["ms"], 4),
              "dkv", round(bwd["dkv"]["ms"], 4), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
