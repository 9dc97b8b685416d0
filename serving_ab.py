"""Serve the Llama-3-8B trace of two trees (or more) on one GPU, in turns.

    python serving_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...]

Each root is a checkout of this repository (for example a ``git archive``
of the parent commit unpacked into a git-ignored directory). For every
turn (parent, change, change, parent; with more roots, each root in
order and then in reverse) a fresh Python process imports
``chip_smoke.py`` from that root, builds its kernels there, makes the
default stream's fp8 cast scratch (as ``chip_smoke.py``'s kernels phase
does), times the host's cost of a wrapper call (the median of 5 passes of
4000 back-to-back calls of the fp8 cast on 4096 bf16 elements and of
RMSNorm on 8 x 4096, whose kernels take less than their calls, so the
wall time a call is the host's), and runs its ``phase_serving``,
``phase_profile`` and ``phase_serving_fp8``. Each turn prints one JSON
line (tokens/s, TTFT, latency, the tokens' SHA-1, the profile's decode
step and idle share, the calls' host µs); a one-line summary a turn
follows. Compare two versions only inside one
such run: two runs may land on different cards.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = r"""
import gc, importlib.util, json, statistics, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
dev = cs.phase_device()
cs.phase_build()
if hasattr(cs, "use_tuning_cache"):
    # the untuned plans, as chip_smoke.py's main() reads them
    cs.use_tuning_cache(cs.UNTUNED_CACHE)
from apex_tpu_torch.ops import fp8_cast_kernel as fc
fc._cast_and_scale_cuda(torch.ones(64, device="cuda", dtype=torch.bfloat16),
                        1.0, torch.float8_e4m3fn, 448.0)
torch.cuda.synchronize()
from apex_tpu_torch.ops import layer_norm as ln


def host_us(call, n=4000):
    for _ in range(200):
        call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


xc = torch.randn(4096, device="cuda").to(torch.bfloat16)
xn = torch.randn(8, 4096, device="cuda").to(torch.bfloat16)
wn = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
calls = {"fp8_cast": lambda: fc.cast_and_scale_stats(
             xc, 1.0, torch.float8_e4m3fn, 448.0),
         "rms_norm": lambda: ln.rms_norm(xn, wn, 4096)}
host = {k: statistics.median(host_us(c) for _ in range(5))
        for k, c in calls.items()}
cs.reset_counts()
params, cfg, native, serving = cs.phase_serving()
prof = cs.phase_profile(params, cfg)
gc.collect()
torch.cuda.empty_cache()
fp8 = cs.phase_serving_fp8(params, cfg, native)
keys = ("tokens_sha1", "tokens_per_s", "wall_s", "ttft_p50_ms",
        "ttft_p99_ms", "latency_p50_ms", "latency_p99_ms",
        "peak_memory_bytes", "decode_steps", "replayed_step", "capture_s")
pick = lambda r: {k: r[k] for k in keys if k in r}
print(json.dumps({"root": root, "device": dev["nvidia_smi"],
                  "host_us_per_call": host,
                  "serving": pick(serving), "serving_fp8": pick(fp8),
                  "profile": {k: v for k, v in prof.items()
                              if k != "top_kernels"}}), flush=True)
"""


def summary(turn: dict) -> str:
    if "serving" not in turn:
        return json.dumps(turn)
    s, f, p = turn["serving"], turn["serving_fp8"], turn["profile"]
    return (f"{turn['root']} {turn['device']} bf16 {s['tokens_per_s']:.2f} "
            f"tokens/s {s['tokens_sha1'][:8]} ttft50 {s['ttft_p50_ms']:.1f} "
            f"lat50 {s['latency_p50_ms']:.1f} | fp8 {f['tokens_per_s']:.2f} "
            f"{f['tokens_sha1'][:8]} | decode step mean "
            f"{p['decode_step_ms_mean']:.3f} ms, median "
            f"{p.get('decode_step_ms_median')}, idle "
            f"{p['device_idle_share']:.4f} | host us a call "
            f"{json.dumps(turn.get('host_us_per_call'))}")


def main() -> int:
    roots = sys.argv[1:]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", CHILD, root],
                              capture_output=True, text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        turn = (json.loads(lines[-1]) if lines and proc.returncode == 0
                else {"root": root, "rc": proc.returncode,
                      "stderr": proc.stderr[-3000:]})
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    for turn in turns:
        print(summary(turn), flush=True)
    return 0 if all("serving" in t for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
