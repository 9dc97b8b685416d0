#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON object, each failing the run (exit 1, no
result line) when it fails:

1. device   -- the card's name and power limit (``nvidia-smi``), the
               peaks the bounds below are computed from.
2. build    -- every CUDA kernel of the serving path, compiled from
               ``apex_tpu_torch/ops/csrc`` by nvcc for sm_90a, in parallel.
3. kernels  -- each kernel against its plain PyTorch version on the card
               at the serving path's shapes, with the tolerance stated,
               and timed (kernel, plain version, library call, bound).
4. serving  -- Llama-3-8B at full width and depth, random bf16 weights
               from a seeded generator, served by ``ServingEngine`` over a
               16-request closed-loop trace; every launch counter must
               match the path's expected count, and a teacher-forced pass
               of the full ``forward`` must agree with the engine's tokens.
5. profile  -- only with ``--profile``: host time per prefill and decode
               step, the device's busy share and its time by kernel.

The last lines are the per-kernel summary, the card line and the result
object ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the ``apex_tpu_torch`` package beside it, the script exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Llama-3-8B serving geometry and trace
PAGE_SIZE = 16
MAX_BATCH = 8
MAX_PROMPT = 512
MAX_NEW = 64
TRACE = dict(seed=SEED, num_requests=16, prompt_lens=(128, 256, 512),
             output_lens=(32, 64), vocab_size=128256)

# teacher-forced agreement: the engine's token at each generated
# position must have a logit within DELTA of that row's maximum under the
# full-sequence forward. Both sides run the same bf16 model through
# different shapes (a paged one-token decode vs one pass over the whole
# sequence), so bf16 rounding lands in different places; DELTA covers the
# logit spread between two such equal runs (measured below as
# ``spread``: the same positions through forward passes of two lengths),
# with room to spare. A wrong kernel or cache moves logits by O(1).
DELTA = 0.25

# the spin that holds the stream while calls are queued: 1e8 cycles, at
# least SPIN_MS at the H100's clocks (at most 1.98 GHz)
SPIN_CYCLES = 100_000_000
SPIN_MS = SPIN_CYCLES / 2.0e9 * 1e3

# (substring of the card's name, HBM bytes/s, dense bf16 FLOP/s, fp32
# FLOP/s outside the tensor cores), from NVIDIA's data sheets
PEAKS = (("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100", 3.35e12, 989e12, 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------- timing


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device ms per call of ``fn(*args)``: CUDA events around
    ``iters`` calls after a warm-up. A spin kernel holds the stream while
    the host queues every call, so the events see the calls run back to
    back on the card and not the host's launch overhead. The calls cycle
    through ``arg_sets`` (copies of the inputs that together exceed the
    50 MB L2), so each reads its inputs from device memory."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    queued_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if queued_s * 1e3 > SPIN_MS:
        raise RuntimeError("the host took longer to queue the calls than "
                           "the spin kernel held the stream")
    return start.elapsed_time(end) / iters


def host_ms(fn, args, iters: int = 20) -> float:
    """Mean wall ms per call of ``fn(*args)`` as a caller pays it, the
    host's launch overhead included (synchronised at both ends)."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def copies(make, nbytes: int):
    """Enough copies of ``make()`` to exceed L2 twice over."""
    n = min(64, max(2, math.ceil(100e6 / max(nbytes, 1))))
    return [make() for _ in range(n)]


def bound(nbytes: float, flops: float, peak_flops: float, dev) -> tuple:
    t_bytes = nbytes / dev["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phases


def phase_device():
    import torch

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    peaks = next((p for p in PEAKS if p[0] in kind), PEAKS[-1])
    return {"phase": "device", "nvidia_smi": smi, "kind": kind,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "peaks_from": peaks[0], "hbm_bytes_per_s": peaks[1],
            "bf16_flops": peaks[2], "fp32_flops": peaks[3]}


def phase_build():
    from apex_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build()
    seconds = time.monotonic() - t0
    # registers and spills of each template instance, as ptxas gives them
    ptxas = {name: sorted({ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln})
             for name, log in logs.items()}
    libs = {name: str(_build.library_path(name).relative_to(ROOT))
            for name in _build.KERNELS}
    return {"phase": "build", "seconds": seconds, "built": sorted(logs),
            "libraries": libs, "ptxas": ptxas}


def check_rms(dev):
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    h, eps = 4096, 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
        torch.bfloat16)
    out = []
    for rows in (8, 512, 4096):
        x = torch.randn(rows, h, generator=g, device="cuda").to(
            torch.bfloat16)
        y, rstd = ln._rms_fwd_cuda(x, w, eps)
        y_ref, rstd_ref = ln._rms_fwd_plain(x, w, eps)
        torch.cuda.synchronize()
        # y: one bf16 ulp (2^-7 relative) for an fp32 sum taken in
        # another order; rstd: fp32 rounding of that sum
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=8e-3,
                                   atol=1e-6)
        torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
        err = float((y.float() - y_ref.float()).abs().max())
        nbytes = 2 * rows * h * 2 + h * 2 + rows * 4
        sets = copies(lambda: torch.randn(rows, h, device="cuda").to(
            torch.bfloat16), nbytes)
        ms = time_ms(lambda a: ln._rms_fwd_cuda(a, w, eps), [
            (a,) for a in sets])
        plain_ms = time_ms(lambda a: ln._rms_fwd_plain(a, w, eps), [
            (a,) for a in sets])
        lib_ms = time_ms(lambda a: F.rms_norm(a, (h,), w, eps), [
            (a,) for a in sets])
        b_ms, b_by = bound(nbytes, 4.0 * rows * h, dev["fp32_flops"], dev)
        call_ms = host_ms(lambda a: ln._rms_fwd_cuda(a, w, eps),
                          (sets[0],))
        out.append({"shape": [rows, h], "dtype": "bfloat16",
                    "max_abs_err": err, "ms": ms, "host_ms": call_ms,
                    "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms,
                    "bound_by": b_by})
    return out


def check_flash(dev):
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attention as fa

    H, H_kv, d = 32, 8, 128
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = []
    for s in (128, 200, 512):
        def make():
            return tuple(torch.randn(1, s, n, d, generator=g,
                                     device="cuda").to(torch.bfloat16)
                         for n in (H, H_kv, H_kv))

        q, k, v = make()
        o, lse = fa._flash_fwd_cuda(q, k, v, True, scale)
        flat = [t.transpose(1, 2).reshape(-1, s, d) for t in (q, k, v)]
        o_ref, lse_ref = fa._flash_fwd_plain(*flat, True, scale)
        o_ref = o_ref.reshape(1, H, s, d).transpose(1, 2)
        torch.cuda.synchronize()
        # o in bf16: both sides keep s, p and the sums in fp32 and round
        # o once; they differ in summation order (blocked online softmax
        # against one pass) and so by up to an ulp of o
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)
        err = float((o.float() - o_ref.float()).abs().max())
        pairs = sum(min(i + 1, s) for i in range(s))  # causal (q, k) pairs
        flops = 4.0 * d * H * pairs
        nbytes = (2 * s * H * d + 2 * s * H_kv * d) * 2 + H * s * 4
        sets = copies(make, nbytes)
        ms = time_ms(lambda a, b, c: fa._flash_fwd_cuda(a, b, c, True,
                                                        scale), sets)

        def plain(a, b, c):
            ft = [t.transpose(1, 2).reshape(-1, s, d) for t in (a, b, c)]
            return fa._flash_fwd_plain(*ft, True, scale)

        def library(a, b, c):
            return F.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)

        plain_ms = time_ms(plain, sets)
        lib_ms = time_ms(library, sets)
        b_ms, b_by = bound(nbytes, flops, dev["bf16_flops"], dev)
        out.append({"shape": [1, s, H, H_kv, d], "dtype": "bfloat16",
                    "causal": True, "max_abs_err": err,
                    "lse_max_abs_err": float((lse - lse_ref).abs().max()),
                    "ms": ms, "host_ms": host_ms(
                        lambda a, b, c: fa._flash_fwd_cuda(a, b, c, True,
                                                           scale), sets[0]),
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "tflops": flops / ms / 1e9})
    return out


def phase_kernels(dev):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"phase": "kernels", "rms_norm_fwd": check_rms(dev),
            "flash_attention_fwd": check_flash(dev)}


def teacher_forced(params, cfg, engine, rids):
    """Re-run the engine's requests through the full ``forward`` and
    measure each generated token's logit gap to its row's maximum."""
    import torch

    from apex_tpu_torch.models import llama

    device = params["embed"].device
    worst, exact, total, spread = 0.0, 0, 0, 0.0
    for rid in rids:
        res = engine.results[rid]
        prompt, toks = res["prompt"], res["tokens"]
        p = len(prompt)
        seq = torch.tensor([prompt + toks[:-1]], device=device)
        logits = llama.forward(params, seq, cfg)[0]
        rows = logits[p - 1:p - 1 + len(toks)]
        picked = rows.gather(1, torch.tensor(toks, device=device)[:, None])
        gap = (rows.max(dim=1).values - picked[:, 0]).cpu()
        worst = max(worst, float(gap.max()))
        exact += int((gap == 0).sum())
        total += len(toks)
        # two equal runs: the prompt's positions through a forward of the
        # prompt alone
        short = llama.forward(params, seq[:, :p], cfg)[0]
        spread = max(spread, float((short - logits[:p]).abs().max()))
        del logits, short
    return {"requests": list(rids), "positions": total,
            "worst_gap": worst, "exact_argmax": exact, "spread": spread,
            "delta": DELTA}


def make_engine(params, cfg):
    """The serving geometry: 8 slots and the pages of 8 worst-case
    requests."""
    from apex_tpu_torch.serving import ServingEngine, pages_per_request

    num_pages = MAX_BATCH * pages_per_request(MAX_PROMPT, MAX_NEW,
                                              PAGE_SIZE)
    return ServingEngine(params, cfg, num_pages=num_pages,
                         page_size=PAGE_SIZE, max_batch=MAX_BATCH,
                         max_prompt_len=MAX_PROMPT, max_new_cap=MAX_NEW)


def phase_serving():
    import torch

    from apex_tpu_torch.models import llama
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.serving import make_trace, run_closed_loop

    cfg = llama.llama3_8b()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    engine = make_engine(params, cfg)
    trace = make_trace(**TRACE)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = ln.launches = 0
    report = run_closed_loop(engine, trace, use_wall_clock=False)
    torch.cuda.synchronize()
    counts = {"flash_attention_fwd": fa.launches,
              "rms_norm_fwd": ln.launches}
    peak = torch.cuda.max_memory_allocated()

    prefills = engine.scheduler.prefill_count
    steps = engine.scheduler.decode_steps
    want = {"flash_attention_fwd": cfg.num_layers * prefills,
            "rms_norm_fwd": (2 * cfg.num_layers + 1) * (prefills + steps)}
    missing = [t.rid for t in trace
               if len(engine.results.get(t.rid, {}).get("tokens", ()))
               != t.max_new_tokens]
    if missing or len(engine.results) != len(trace):
        raise AssertionError(f"requests without their full token count: "
                             f"{missing}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")

    longest = sorted(trace, key=lambda t: (-len(t.prompt), t.rid))
    tf = teacher_forced(params, cfg, engine,
                        [longest[0].rid, longest[-1].rid])
    if tf["worst_gap"] > DELTA or tf["spread"] > DELTA:
        raise AssertionError(f"teacher-forced check failed: {tf}")
    tokens = report["tokens"]
    return params, cfg, {
            "phase": "serving", "model": "llama3_8b", "dtype": "bfloat16",
            "num_layers": cfg.num_layers,
            "num_pages": engine.scheduler.cache.num_pages,
            "page_size": PAGE_SIZE, "max_batch": MAX_BATCH,
            "init_s": init_s, "requests": report["requests"],
            "tokens": tokens, "wall_s": report["wall_s"],
            "tokens_per_s": report["tokens_per_s"],
            "ttft_p50_ms": report["ttft_p50_ms"],
            "ttft_p99_ms": report["ttft_p99_ms"],
            "latency_p50_ms": report["latency_p50_ms"],
            "latency_p99_ms": report["latency_p99_ms"],
            "mean_occupancy": report["mean_occupancy"],
            "prefills": prefills, "decode_steps": steps,
            "peak_memory_bytes": peak, "launches": counts,
            "expected_launches": want, "teacher_forced": tf}


def phase_profile(params, cfg):
    """Where the serving time goes (``--profile``), over a second
    8-request trace. First without the profiler: the host wall time of
    each prefill and decode step (each ends in a host read of its tokens,
    so no synchronisation is added). Then the same trace on a fresh
    engine under ``torch.profiler``: the device's busy time, by kernel.
    The busy time over the first run's wall time is the device's share
    of the unprofiled run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import make_trace, run_closed_loop

    trace = make_trace(**dict(TRACE, seed=SEED + 1, num_requests=8))
    engine = make_engine(params, cfg)
    sched = engine.scheduler
    spans = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spans[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    sched._admit = timed("prefill", sched._admit)
    sched.step_decode = timed("decode", sched.step_decode)
    t0 = time.perf_counter()
    run_closed_loop(engine, trace, use_wall_clock=False, publish=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_closed_loop(make_engine(params, cfg), trace,
                        use_wall_clock=False, publish=False)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:12]
    decode = spans["decode"]
    return {"phase": "profile", "requests": len(trace), "wall_ms": wall_ms,
            "prefill_ms": spans["prefill"],
            "prefill_share": sum(spans["prefill"]) / wall_ms,
            "decode_steps": len(decode),
            "decode_step_ms_mean": sum(decode) / max(1, len(decode)),
            "decode_share": sum(decode) / wall_ms,
            "profiled_wall_ms": profiled_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_idle_share_profiled": 1.0 - busy_ms / profiled_ms,
            "kernels_seen": len(device),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def summary(kernels, serving):
    def row(name, source, replaces, results, pick):
        r = results[pick]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": serving["launches"][name],
                "max_abs_err": max(x["max_abs_err"] for x in results),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"]}

    # timed at the longest prompt's prefill shape (rows = 512 tokens)
    return {"kernels": [
        row("flash_attention_fwd", "apex_tpu_torch/ops/csrc/flash_fwd.cu",
            "apex_tpu/ops/flash_attention.py:65",
            kernels["flash_attention_fwd"], -1),
        row("rms_norm_fwd", "apex_tpu_torch/ops/csrc/rms_norm.cu",
            "apex_tpu/ops/layer_norm.py:56", kernels["rms_norm_fwd"], 1),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "apex_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: apex_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    phase = "device"
    try:
        dev = phase_device()
        emit(dev)
        phase = "build"
        emit(phase_build())
        phase = "kernels"
        kernels = phase_kernels(dev)
        emit(kernels)
        phase = "serving"
        params, cfg, serving = phase_serving()
        emit(serving)
        if "--profile" in sys.argv[1:]:
            phase = "profile"
            emit(phase_profile(params, cfg))
        del params
    except Exception as exc:  # report which phase failed, then fail
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"[:2000]})
        return 1
    emit({"kernel_counts": serving["launches"]})
    emit(summary(kernels, serving))
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
