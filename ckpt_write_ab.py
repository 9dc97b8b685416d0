"""Time GPT-2 345M train steps beside an async checkpoint write, for two
settings of the writer's threads, in turns, on one GPU.

    python ckpt_write_ab.py [--rounds N] [--steps S] [--idle SECONDS]
    python ckpt_write_ab.py --chaos-trace

Builds the kernels, makes ``chip_smoke.py``'s gpt2_resilient state (GPT-2
345M, bf16 params, tree-mode Adam in fp32: a 3.55 GB checkpoint) and
step, and first times ``--steps`` steps with no write in flight. Then,
for each setting in turns (A B B A, ``--rounds`` times over), one async
``save`` of the state, ``--steps`` steps beside the write (wall ms from
the host's clock; device ms between CUDA events around the step, which
start after the snapshot's copy, on which the step waits; the device ms
from before ``save`` to the first step's start, that copy), then the
commit. The settings: ``threads8_nice0`` (8 writer threads at the
caller's priority) and ``threads2_nice10`` (2 threads at niceness 10,
``apex_tpu_torch.checkpoint``'s defaults). One JSON line a round; a
summary line of medians ends the output.

Then what a resumed loop's first steps pass through, each case twice in
turns (A B C C B A), 2 steps after it, with the SM clock that
``nvidia-smi`` reads just before the first: ``idle`` (the device idle for
``--idle`` seconds, as during an emergency save and a restore),
``empty_cache`` (the caching allocator emptied, as the phase does between
its loops) and ``save_restore`` (a blocking save, then a restore into
the state). One JSON line a case, before the summary. The checkpoints
are written under the git-ignored ``build/ckpt_write_ab`` and removed.

``--chaos-trace`` instead runs ``chip_smoke.py``'s gpt2_resilient phase
under ``torch.profiler`` and prints, for each step of its loops (the
``timer/resilience/step_s`` ranges), the host span, the device's busy
time inside it (the union of its kernels and copies), its longest idle
gaps, the time in ``cudaMalloc`` and the CUDA runtime calls over 5 ms in
it: a slow step whose device sat idle waited on the host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SETTINGS = {"threads8_nice0": (8, 0), "threads2_nice10": (2, 10)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--idle", type=float, default=13.0)
    ap.add_argument("--chaos-trace", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    dev = cs.phase_device()
    cs.phase_build()
    if args.chaos_trace:
        return chaos_trace(cs, dev)
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.models import gpt2
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt2.gpt2_345m()
    tx = fused_adam(lr=cs.GPT2_LR)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = gpt2.init_params(gen, cfg, device="cuda")
    state = {"params": params, "opt": tx.init(params)}
    step_no = [0]

    def step():
        """One train step: (wall ms, device ms, its start event)."""
        g = torch.Generator(device="cuda").manual_seed(step_no[0])
        tokens = torch.randint(0, cfg.vocab_size,
                               (cs.GPT2_BATCH, cs.GPT2_SEQ), generator=g,
                               device="cuda")
        t0 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        p, o, loss = gpt2.train_step(
            state["params"], state["opt"],
            (tokens, torch.roll(tokens, -1, dims=-1)), cfg, tx, remat=True,
            vocab_chunks=cs.GPT2_CHUNKS)
        end.record()
        float(loss)
        state["params"], state["opt"] = p, o
        step_no[0] += 1
        return ((time.perf_counter() - t0) * 1e3, start.elapsed_time(end),
                start)

    out_dir = ROOT / "build" / "ckpt_write_ab"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    step()  # warm-up
    plain = [step() for _ in range(args.steps + 1)]
    writer = ckpt.AsyncCheckpointWriter()
    writer.save(str(out_dir), state, step=0)  # allocates the pinned buffers
    writer.wait()
    shutil.rmtree(out_dir / "step_00000000")
    names = list(SETTINGS)
    order = (names + names[::-1]) * args.rounds
    rows = []
    for i, name in enumerate(order):
        ckpt._WRITE_WORKERS, ckpt._BACKGROUND_NICE = SETTINGS[name]
        # a fence: the save's host seconds start on an idle card
        torch.cuda.synchronize()  # apex-lint: disable=sync-timing
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        t0 = time.perf_counter()
        writer.save(str(out_dir), state, step=i + 1)
        host_s = time.perf_counter() - t0
        steps = [step() for _ in range(args.steps)]
        busy = writer.writing
        writer.wait()
        commit_s = time.perf_counter() - t0
        nbytes = sum(m["size"] for m in ckpt.read_manifest(
            str(out_dir / f"step_{i + 1:08d}"))["files"].values())
        shutil.rmtree(out_dir / f"step_{i + 1:08d}")
        row = {"round": i, "setting": name, "async_save_host_s": host_s,
               "step_wall_ms": [w for w, _, _ in steps],
               "step_device_ms": [d for _, d, _ in steps],
               "save_to_first_step_device_ms": before.elapsed_time(
                   steps[0][2]),
               "write_in_flight_after_steps": busy,
               "save_to_commit_s": commit_s,
               "write_gb_per_s": nbytes / commit_s / 1e9,
               "checkpoint_bytes": nbytes}
        rows.append(row)
        print(json.dumps(row), flush=True)
    writer.close()

    def sm_clock():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()

    def pause(case):
        # fences: a pause's wall seconds are the host's, on an idle card
        torch.cuda.synchronize()  # apex-lint: disable=sync-timing
        if case == "idle":
            time.sleep(args.idle)
        elif case == "empty_cache":
            torch.cuda.empty_cache()
        else:
            ckpt.save_checkpoint(str(out_dir), state, step=999)
            ckpt.restore_checkpoint(str(out_dir), target=state, step=999)
            shutil.rmtree(out_dir / "step_00000999")
        torch.cuda.synchronize()  # apex-lint: disable=sync-timing

    cases = ["idle", "empty_cache", "save_restore"]
    for case in cases + cases[::-1]:
        t0 = time.perf_counter()
        pause(case)
        pause_s = time.perf_counter() - t0
        clock = sm_clock()
        steps = [step() for _ in range(2)]
        print(json.dumps({"after": case, "pause_s": pause_s,
                          "sm_clock_before": clock,
                          "step_wall_ms": [w for w, _, _ in steps],
                          "step_device_ms": [d for _, d, _ in steps]}),
              flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)

    def med(name, key, first_only=False):
        vals = [v for r in rows if r["setting"] == name
                for v in (r[key][:1] if first_only else r[key][1:])]
        return statistics.median(vals)

    print(json.dumps({
        "device": dev["nvidia_smi"],
        "no_write": {"step_wall_ms": [w for w, _, _ in plain[1:]],
                     "step_device_ms": [d for _, d, _ in plain[1:]]},
        **{name: {"save_to_first_step_device_ms": [
                      r["save_to_first_step_device_ms"] for r in rows
                      if r["setting"] == name],
                  "first_step_wall_ms_median": med(name, "step_wall_ms",
                                                    True),
                  "first_step_device_ms_median": med(name, "step_device_ms",
                                                      True),
                  "later_steps_wall_ms_median": med(name, "step_wall_ms"),
                  "later_steps_device_ms_median": med(name,
                                                      "step_device_ms"),
                  "save_to_commit_s": [r["save_to_commit_s"] for r in rows
                                       if r["setting"] == name]}
           for name in names}}), flush=True)
    return 0


def chaos_trace(cs, dev) -> int:
    """The gpt2_resilient phase under the profiler: each loop step's
    host span against its device busy time (see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = cs.phase_gpt2_resilient(dev)
    events = prof.events()
    # kernels and copies; a record_function scope also lands on the
    # device's timeline (an annotation spanning its work): not work
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("timer/"))
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name == "timer/resilience/step_s")
    mallocs = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CPU and e.name == "cudaMalloc"]
    calls = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith("cuda")
             and e.time_range.end - e.time_range.start > 5000]
    for i, (t0, t1) in enumerate(steps):
        busy, gaps, cursor = 0.0, [], t0
        for a, b in device:
            if b <= cursor or a >= t1:
                continue
            a = max(a, cursor)
            if a - cursor > 2000:
                gaps.append([round((cursor - t0) / 1e3, 3),
                             round((a - cursor) / 1e3, 3)])
            busy += min(b, t1) - a
            cursor = min(b, t1)
        if t1 - cursor > 2000:
            gaps.append([round((cursor - t0) / 1e3, 3),
                         round((t1 - cursor) / 1e3, 3)])
        print(json.dumps({
            "step_range": i, "span_ms": (t1 - t0) / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_gaps_ms_at": sorted(gaps, key=lambda g: -g[1])[:5],
            "cuda_malloc_ms": sum(b - a for a, b in mallocs
                                  if t0 <= a < t1) / 1e3,
            "runtime_calls_over_5ms": [
                [n, round((a - t0) / 1e3, 3), round((b - a) / 1e3, 3)]
                for a, b, n in calls if t0 <= a < t1]}), flush=True)
    chaos = result["chaos"]
    print(json.dumps({"device": dev["nvidia_smi"],
                      "events": chaos["events"],
                      "step_done_ms": chaos["step_done_ms"],
                      "step_device_ms": chaos["step_device_ms"],
                      "checkpoint_saved_host_s":
                          chaos["checkpoint_saved_host_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
