#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON object, each failing the run (exit 1, no
result line) when it fails:

1. device   -- the card's name and power limit (``nvidia-smi``), the
               peaks the bounds below are computed from.
2. build    -- every CUDA kernel of the serving and training paths,
               compiled from ``apex_tpu_torch/ops/csrc`` by nvcc for
               sm_90a, one process per source, all started together.
3. kernels  -- each kernel against its plain PyTorch version on the card
               at its path's shapes, with the tolerance stated, and timed
               (kernel, host call, plain version, library call, bound).
4. serving  -- Llama-3-8B at full width and depth, random bf16 weights
               from a seeded generator, served by ``ServingEngine`` over a
               16-request closed-loop trace; every launch counter must
               match the path's expected count, and a teacher-forced pass
               of the full ``forward`` must agree with the engine's tokens.
5. profile  -- only with ``--profile``: host time per prefill and decode
               step, the device's busy share and its time by kernel.
6. training -- Llama-3-8B width cut to 4 layers (random bf16 weights from
               a seeded generator), batch 2 x 2048: the kernel path's
               gradients at step 0 against an fp32 reference built from
               the port's plain functions with ordinary autograd, then 3
               ``train_step``s with ``fused_adam(flat=True)``: exact launch
               counts per step, the first step's Adam launch against its
               plain version on the packed slab, finite and falling loss,
               step time, tokens/s, MFU and peak memory.
7. profile  -- only with ``--profile``: one more training step under
               ``torch.profiler``, the device's busy share and its time
               by kernel.

The last lines are the per-kernel summary, the card line and the result
object ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the ``apex_tpu_torch`` package beside it, the script exits 1.
"""

from __future__ import annotations

import gc
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

# Llama-3-8B training geometry: 4 of the 32 layers (one card cannot hold
# the full model's params, grads and fp32 Adam m/v: 96 GB), bench.py's
# sequence length and lr
TRAIN_LAYERS = 4
TRAIN_BATCH = 2
TRAIN_SEQ = 2048
TRAIN_LR = 1e-4
TRAIN_STEPS = 3

# gradient agreement at step 0 of the training phase, per param leaf,
# between the kernel path (bf16 params, activations and grads) and an fp32
# reference of the same model and batch through the plain functions. bf16
# keeps 8 significant bits: each stored activation, matmul output and
# gradient is rounded at 2^-9 relative, and a gradient passes some tens
# of such roundings on its way back through 4 layers, whose errors add
# roughly in quadrature: about 1% relative L2 in all. GRAD_REL_L2 leaves
# room above that; a wrong mask, scale, GQA head or missing term moves a
# leaf's gradient by O(1). The same bf16 model through the plain
# functions is measured alongside as the floor of bf16 rounding.
GRAD_REL_L2 = 0.05
GRAD_COS = 0.998

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
    """Sets of inputs from ``make()`` that together exceed the 50 MB L2
    twice over, so timed calls read from device memory: one set when one
    already does, never more than 64 sets or about 1 GB in all."""
    n = min(64, math.ceil(100e6 / max(nbytes, 1)),
            max(1, int(1e9 // max(nbytes, 1))))
    return [make() for _ in range(max(1, n))]


def max_err(got, ref, rel: float, what: str) -> float:
    """max |got - ref|, failing above ``rel`` times max |ref|: the error
    against the output's own scale, for outputs that are sums whose
    rounding grows with their terms."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= rel * scale:
        raise AssertionError(f"{what}: max |kernel - plain| {err} > "
                             f"{rel} x max |plain| {scale}")
    return err


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
    # serving prefills of 128, 200 and 512 tokens; the training batch
    for b, s in ((1, 128), (1, 200), (1, 512), (TRAIN_BATCH, TRAIN_SEQ)):
        def make():
            return tuple(torch.randn(b, s, n, d, generator=g,
                                     device="cuda").to(torch.bfloat16)
                         for n in (H, H_kv, H_kv))

        q, k, v = make()
        o, lse = fa._flash_fwd_cuda(q, k, v, True, scale)
        flat = [fa._heads_major(t) for t in (q, k, v)]
        o_ref, lse_ref = fa._flash_fwd_plain(*flat, True, scale)
        o_ref = o_ref.reshape(b, H, s, d).transpose(1, 2)
        torch.cuda.synchronize()
        # o in bf16: both sides keep s, p and the sums in fp32 and round
        # o once; they differ in summation order (blocked online softmax
        # against one pass) and so by up to an ulp of o
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)
        err = float((o.float() - o_ref.float()).abs().max())
        pairs = b * s * (s + 1) // 2  # causal (q, k) pairs per head
        flops = 4.0 * d * H * pairs
        nbytes = b * (2 * s * H * d + 2 * s * H_kv * d) * 2 + b * H * s * 4
        sets = copies(make, nbytes)
        ms = time_ms(lambda a, b_, c: fa._flash_fwd_cuda(a, b_, c, True,
                                                         scale), sets)

        def plain(a, b_, c):
            ft = [fa._heads_major(t) for t in (a, b_, c)]
            return fa._flash_fwd_plain(*ft, True, scale)

        def library(a, b_, c):
            return F.scaled_dot_product_attention(
                a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)

        plain_ms = time_ms(plain, sets)
        lib_ms = time_ms(library, sets)
        b_ms, b_by = bound(nbytes, flops, dev["bf16_flops"], dev)
        out.append({"shape": [b, s, H, H_kv, d], "dtype": "bfloat16",
                    "causal": True, "max_abs_err": err,
                    "lse_max_abs_err": float((lse - lse_ref).abs().max()),
                    "ms": ms, "host_ms": host_ms(
                        lambda a, b_, c: fa._flash_fwd_cuda(a, b_, c, True,
                                                            scale), sets[0]),
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "tflops": flops / ms / 1e9})
        del sets, q, k, v, o, lse, o_ref, lse_ref, flat
    return out


def check_flash_bwd(dev):
    """dq and dk/dv at the training shape, against _flash_bwd_plain on the
    same (q, k, v, o, lse, do). The plain and library times cover all of
    dq, dk and dv (they compute them together)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attention as fa

    b, s, H, H_kv, d = TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(n):
        return torch.randn(b, s, n, d, generator=g, device="cuda").to(
            torch.bfloat16)

    def make():
        q, k, v, do = randn(H), randn(H_kv), randn(H_kv), randn(H)
        o, lse = fa._flash_fwd_cuda(q, k, v, True, scale)
        return q, k, v, o, lse, do, fa._flash_delta(o, do)

    q, k, v, o, lse, do, delta = make()
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, scale)
    ref = fa._flash_bwd_plain(*(fa._heads_major(t) for t in (q, k, v, o)),
                              lse, fa._heads_major(do), True, scale)
    torch.cuda.synchronize()
    # bf16 outputs: both sides sum in fp32 (in other orders) and round
    # each value once to bf16 (2^-9 relative), so |kernel - plain| stays
    # within 1% of the output's largest value
    errs = {}
    for name, got, r, n in (("dq", dq, ref[0], H), ("dk", dk, ref[1], H_kv),
                            ("dv", dv, ref[2], H_kv)):
        r = r.reshape(b, n, s, d).transpose(1, 2)
        errs[name] = max_err(got, r, 1e-2, f"flash {name}")
    del dq, dk, dv, ref
    pairs = b * H * s * (s + 1) // 2  # causal (q, k) pairs
    io = 2 * b * s * (2 * H + 2 * H_kv) * d + 2 * 4 * b * H * s
    dq_bytes = io + 2 * b * s * H * d
    dkv_bytes = io + 2 * 2 * b * s * H_kv * d
    sets = copies(make, dkv_bytes)

    def dq_call(q, k, v, o, lse, do, delta):
        return fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, scale)

    def dkv_call(q, k, v, o, lse, do, delta):
        return fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True, scale)

    def plain(q, k, v, o, lse, do, delta):
        return fa._flash_bwd_plain(
            *(fa._heads_major(t) for t in (q, k, v, o)), lse,
            fa._heads_major(do), True, scale)

    graphs = []
    for q, k, v, o, lse, do, delta in sets:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             scale=scale, enable_gqa=True)
        graphs.append((out, (qt, kt, vt), do.transpose(1, 2)))

    def library(out, inputs, grad):
        return torch.autograd.grad(out, inputs, grad, retain_graph=True)

    res = {"shape": [b, s, H, H_kv, d], "dtype": "bfloat16", "causal": True,
           "max_abs_err": errs, "pairs": pairs,
           "plain_ms": time_ms(plain, sets, iters=5),
           "library_ms": time_ms(library, graphs),
           "library": "backward of F.scaled_dot_product_attention "
                      "(enable_gqa), dq+dk+dv"}
    for name, call, flops, nbytes in (
            ("dq", dq_call, 6.0 * d * pairs, dq_bytes),
            ("dkv", dkv_call, 8.0 * d * pairs, dkv_bytes)):
        ms = time_ms(call, sets)
        b_ms, b_by = bound(nbytes, flops, dev["bf16_flops"], dev)
        res[name] = {"ms": ms, "host_ms": host_ms(call, sets[0]),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "tflops": flops / ms / 1e9}
    return res


def check_rms_bwd(dev):
    """The backward at the training path's rows (b*s = 4096) x h 4096."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    rows, h, eps = TRAIN_BATCH * TRAIN_SEQ, 4096, 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
        torch.bfloat16)

    def make():
        x, dy = (torch.randn(rows, h, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        return x, dy, ln._rms_fwd_cuda(x, w, eps)[1]

    x, dy, rstd = make()
    dx, dw = ln._rms_bwd_cuda(x, w, rstd, dy)
    dx_ref, dw_ref = ln._rms_bwd_plain(x, w, rstd, dy)
    torch.cuda.synchronize()
    # each value is an fp32 sum (over h for dx, over the rows for dw)
    # taken in another order and rounded once to bf16: within one bf16
    # ulp (2^-8 relative) of the output's scale
    errs = {"dx": max_err(dx, dx_ref, 8e-3, "rms dx"),
            "dw": max_err(dw, dw_ref, 8e-3, "rms dw")}
    nbytes = 3 * rows * h * 2 + rows * 4 + 2 * h * 2
    sets = copies(make, nbytes)

    def call(x, dy, rstd):
        return ln._rms_bwd_cuda(x, w, rstd, dy)

    def plain(x, dy, rstd):
        return ln._rms_bwd_plain(x, w, rstd, dy)

    graphs = []
    for x, dy, _ in sets:
        xl = x.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        graphs.append((F.rms_norm(xl, (h,), wl, eps), (xl, wl), dy))

    def library(y, inputs, grad):
        return torch.autograd.grad(y, inputs, grad, retain_graph=True)

    ms = time_ms(call, sets)
    b_ms, b_by = bound(nbytes, 10.0 * rows * h, dev["fp32_flops"], dev)
    return {"shape": [rows, h], "dtype": "bfloat16", "max_abs_err": errs,
            "ms": ms, "host_ms": host_ms(call, sets[0]),
            "plain_ms": time_ms(plain, sets),
            "library_ms": time_ms(library, graphs),
            "library": "backward of F.rms_norm, dx+dw",
            "bound_ms": b_ms, "bound_by": b_by}


def check_adam(dev):
    """One flat Adam pass over a 2^27-element slab: bf16 params, fp32
    grads and m/v, fused_adam's defaults at bench.py's lr."""
    import torch

    from apex_tpu_torch.ops import fused_adam_kernel as fak

    n = 1 << 27
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
              adam_w_mode=True, bias_correction=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(scale):
        return torch.randn(n, generator=g, device="cuda").mul_(scale)

    grad, m, v = randn(1e-3), randn(1e-4), randn(1e-3).square_()
    p = randn(2e-2).to(torch.bfloat16)
    m_ref, v_ref = m.clone(), v.clone()
    delta, _, _ = fak._adam_flat_cuda(grad, p, m, v, TRAIN_LR, 10, **kw)
    d_ref, _, _ = fak._adam_flat_plain(grad, p, m_ref, v_ref, TRAIN_LR, 10,
                                       **kw)
    torch.cuda.synchronize()
    # the kernel rounds every operation on its own, as the plain
    # version's eager ops do: m and v within a few fp32 ulps, delta
    # within one bf16 ulp
    torch.testing.assert_close(m, m_ref, rtol=2e-6, atol=0)
    torch.testing.assert_close(v, v_ref, rtol=2e-6, atol=0)
    torch.testing.assert_close(delta.float(), d_ref.float(), rtol=8e-3,
                               atol=0)
    errs = {"delta": float((delta.float() - d_ref.float()).abs().max()),
            "m": float((m - m_ref).abs().max()),
            "v": float((v - v_ref).abs().max())}
    del m_ref, v_ref, d_ref, delta
    # g, p, m, v read once; delta, m, v written once
    nbytes = n * (4 + 2 + 4 + 4 + 2 + 4 + 4)
    sets = [(grad, p, m, v)]  # 3.2 GB: one set is far beyond L2

    def call(grad, p, m, v):
        return fak._adam_flat_cuda(grad, p, m, v, TRAIN_LR, 10, **kw)

    def plain(grad, p, m, v):
        return fak._adam_flat_plain(grad, p, m, v, TRAIN_LR, 10, **kw)

    ms = time_ms(call, sets)
    plain_ms = time_ms(plain, sets, iters=5)
    call_ms = host_ms(call, sets[0])
    del m, v, p
    param = torch.zeros(n, device="cuda", requires_grad=True)
    param.grad = grad
    opt = torch.optim.AdamW([param], lr=TRAIN_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0, fused=True)
    lib_ms = time_ms(opt.step, [()])
    b_ms, b_by = bound(nbytes, 15.0 * n, dev["fp32_flops"], dev)
    return {"n": n, "param_dtype": "bfloat16", "max_abs_err": errs,
            "ms": ms, "host_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "torch.optim.AdamW(fused=True).step on fp32 "
                       "buffers of the same size",
            "bound_ms": b_ms, "bound_by": b_by,
            "gb_per_s": nbytes / ms / 1e6}


def phase_kernels(dev):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "kernels", "rms_norm_fwd": check_rms(dev),
           "flash_attention_fwd": check_flash(dev),
           "flash_attention_bwd": check_flash_bwd(dev),
           "rms_norm_bwd": check_rms_bwd(dev),
           "fused_adam": check_adam(dev)}
    torch.cuda.empty_cache()
    return out


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
    reset_counts()
    report = run_closed_loop(engine, trace, use_wall_clock=False)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    prefills = engine.scheduler.prefill_count
    steps = engine.scheduler.decode_steps
    # no gradients while serving: the backward and Adam kernels stay at 0
    want = dict({k: 0 for k in counts},
                flash_attention_fwd=cfg.num_layers * prefills,
                rms_norm_fwd=(2 * cfg.num_layers + 1) * (prefills + steps))
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


def reference_loss(params, tokens, targets, cfg):
    """The training loss through the port's plain functions and ordinary
    torch autograd: _rms_fwd_plain, _reference_attention (the full
    softmax, no lse) and a log-softmax CE, in the params' dtype."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.models import llama
    from apex_tpu_torch.ops.flash_attention import _reference_attention
    from apex_tpu_torch.ops.layer_norm import _rms_fwd_plain

    def norm(x, w):
        y, _ = _rms_fwd_plain(x.reshape(-1, x.shape[-1]), w, cfg.rms_eps)
        return y.reshape(x.shape)

    def heads_major(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])

    b, s = tokens.shape
    d = cfg.head_dim
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens]
    for idx in range(cfg.num_layers):
        lp = llama.layer(params, idx)
        q, k, v = llama._qkv(norm(x, lp["attn_norm"]), lp, cfg, positions)
        o = _reference_attention(heads_major(q), heads_major(k),
                                 heads_major(v), True, d ** -0.5)
        o = o.reshape(b, cfg.num_heads, s, d).transpose(1, 2).reshape(
            b, s, -1)
        x = x + o @ lp["wo"]
        h = norm(x, lp["mlp_norm"])
        x = x + (F.silu(h @ lp["wg"]) * (h @ lp["wu"])) @ lp["wd"]
    logits = (norm(x, params["final_norm"]) @ params["lm_head"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


def grad_check(params, batch, cfg):
    """Per-leaf relative L2 error and cosine of the kernel path's step-0
    gradients against the fp32 plain-autograd reference, with the same
    bf16 model through the plain functions as the rounding floor."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.models import llama

    leaf_paths = _tree.paths(params)

    def grads_of(loss_of, tree):
        live = _tree.map_leaves(lambda t: t.detach().requires_grad_(), tree)
        loss = loss_of(live)
        grads = torch.autograd.grad(loss, _tree.leaves(live))
        return float(loss.detach()), list(grads)

    loss, kernel = grads_of(
        lambda t: llama.loss_fn(t, batch, cfg, remat=False), params)
    loss32, ref = grads_of(lambda t: reference_loss(t, *batch, cfg),
                           _tree.map_leaves(lambda t: t.float(), params))
    loss16, plain = grads_of(lambda t: reference_loss(t, *batch, cfg),
                             params)
    leaves = {}
    for path, g, r, pl in zip(leaf_paths, kernel, ref, plain):
        r_norm = torch.linalg.vector_norm(r)
        g32, p32 = g.float(), pl.float()
        leaves[".".join(path)] = {
            "rel_l2": float(torch.linalg.vector_norm(g32 - r) / r_norm),
            "cos": float(torch.sum(g32 * r) / (
                torch.linalg.vector_norm(g32) * r_norm)),
            "plain_bf16_rel_l2": float(
                torch.linalg.vector_norm(p32 - r) / r_norm)}
        del g32, p32
    del kernel, ref, plain
    bad = {k: v for k, v in leaves.items()
           if not (v["rel_l2"] <= GRAD_REL_L2 and v["cos"] >= GRAD_COS)}
    out = {"loss": loss, "loss_fp32_reference": loss32,
           "loss_plain_bf16": loss16, "rel_l2_tol": GRAD_REL_L2,
           "cos_tol": GRAD_COS, "leaves": leaves,
           "worst_rel_l2": max(v["rel_l2"] for v in leaves.values()),
           "worst_cos": min(v["cos"] for v in leaves.values())}
    if bad:
        raise AssertionError(f"gradients off the fp32 reference: {bad}")
    return out


def reset_counts():
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.ops import layer_norm as ln

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    ln.launches = ln.bwd_launches = fak.launches = 0


def read_counts():
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.ops import layer_norm as ln

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "rms_norm_fwd": ln.launches, "rms_norm_bwd": ln.bwd_launches,
            "fused_adam": fak.launches}


def step_flops(n_params: int, n_layers: int, hidden: int, seq: int,
               batch: int) -> int:
    """fwd+bwd FLOPs of one decoder train step, ``B*S*(6N + 12*L*h*S)``:
    PaLM appendix accounting (6N for the parameter matmuls forward and
    backward, the second term for the attention score and value
    matmuls), as the JAX package's observability layer counts it."""
    return batch * seq * (6 * n_params + 12 * n_layers * hidden * seq)


def step_flops_causal(n_matmul: int, n_layers: int, hidden: int, seq: int,
                      batch: int) -> int:
    """The work this step's matmuls and kernels do: 6 flops a token for
    each matmul parameter (``n_matmul`` leaves out the embedding table,
    which is a gather), and the attention products over the causal
    (q, k) pairs alone, which are all the flash kernels compute:
    ``12*L*h`` a pair, ``S*(S+1)/2`` pairs a sequence, where the PaLM
    count takes ``S*S``."""
    return (6 * n_matmul * batch * seq
            + 12 * n_layers * hidden * batch * seq * (seq + 1) // 2)


# the Adam check on the training path's slab runs the plain version over
# chunks of this many elements: the pass is elementwise, so chunks give
# the values of one whole pass, and the fp32 temporaries stay ~4 GB
ADAM_CHUNK = 1 << 27


def checked_adam(real, plain, found):
    """A stand-in for ``_adam_flat_cuda`` for one train step. It launches
    the kernel through ``real`` (one count, as always), then holds that
    launch's delta, m and v on the path's own packed slab against
    ``plain`` on the same g, p and the old m and v, with the tolerances
    of :func:`check_adam`. Appends each slab's worst errors to
    ``found``."""
    import torch

    def launch(g, p, m, v, lr_t, step, **kw):
        m_old, v_old = m.clone(), v.clone()
        delta, m, v = real(g, p, m, v, lr_t, step, **kw)
        worst = {"delta": 0.0, "m": 0.0, "v": 0.0}
        for a in range(0, g.numel(), ADAM_CHUNK):
            part = slice(a, a + ADAM_CHUNK)
            ref = plain(g[part], p[part], m_old[part], v_old[part], lr_t,
                        step, **kw)
            for name, got, r, rtol in (("delta", delta, ref[0], 8e-3),
                                       ("m", m, ref[1], 2e-6),
                                       ("v", v, ref[2], 2e-6)):
                got, r = got[part].float(), r.float()
                torch.testing.assert_close(got, r, rtol=rtol, atol=0,
                                           msg=lambda s: f"adam {name} on "
                                           f"the training slab: {s}")
                worst[name] = max(worst[name],
                                  float((got - r).abs().max()))
            del ref
        del m_old, v_old
        found.append(dict(worst, n=g.numel(), param_dtype=str(p.dtype),
                          step=float(step)))
        return delta, m, v

    return launch


def phase_training(dev):
    """Llama-3-8B width at 4 layers, batch 2 x 2048: the step-0 gradient
    check, then TRAIN_STEPS train_steps with fused_adam(flat=True)."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.optimizers import fused_adam

    cfg = llama.llama3_8b(num_layers=TRAIN_LAYERS)
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda")
    batch = (tokens, torch.roll(tokens, -1, dims=-1))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tree.leaves(params))

    grads = grad_check(params, batch, cfg)
    torch.cuda.empty_cache()

    tx = fused_adam(lr=TRAIN_LR, flat=True)
    opt_state = tx.init(params)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, counts, adam_check = [], [], [], []
    real_adam = fak._adam_flat_cuda
    for i in range(TRAIN_STEPS):
        # the first step (count 1) also holds its Adam launch against the
        # plain version on the packed slab; it is left out of the steady
        # time and of the steady steps' peak memory
        if i == 0:
            fak._adam_flat_cuda = checked_adam(real_adam,
                                               fak._adam_flat_plain,
                                               adam_check)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = llama.train_step(params, opt_state, batch,
                                                   cfg, tx, remat=False)
        losses.append(float(loss))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        fak._adam_flat_cuda = real_adam
        after = read_counts()
        counts.append({k: after[k] - before[k] for k in after})
        if i == 0:
            checked_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(adam_check) != 1:
        raise AssertionError(f"the checked step ran {len(adam_check)} Adam "
                             f"launches through its wrapper, not 1")

    L = cfg.num_layers
    want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "rms_norm_fwd": 2 * L + 1,
            "rms_norm_bwd": 2 * L + 1, "fused_adam": 1}
    if any(c != want for c in counts):
        raise AssertionError(f"launches per step {counts} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = step_flops(n_params, L, cfg.hidden_size, TRAIN_SEQ, TRAIN_BATCH)
    flops_causal = step_flops_causal(n_params - params["embed"].numel(), L,
                                     cfg.hidden_size, TRAIN_SEQ, TRAIN_BATCH)
    # step 1 also allocates the flat Adam slabs and runs the Adam check
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    return params, opt_state, batch, cfg, tx, {
        "phase": "training", "model": "llama3_8b", "num_layers": L,
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "params": n_params, "optimizer": "fused_adam(lr=1e-4, flat=True)",
        "remat": False, "init_s": init_s, "grad_check": grads,
        "losses": losses, "step_ms": step_ms,
        "steady_step_ms": mean_ms,
        "tokens_per_s": tokens_per_step / mean_ms * 1e3,
        "step_flops": flops,
        "tflops_per_s": flops / mean_ms / 1e9,
        "mfu": flops / (mean_ms * 1e-3) / dev["bf16_flops"],
        "step_flops_causal_without_embedding": flops_causal,
        "mfu_causal_without_embedding": flops_causal / (mean_ms * 1e-3)
        / dev["bf16_flops"],
        "peak_memory_bytes": peak,
        "peak_memory_checked_step_bytes": checked_peak,
        "adam_path_check": adam_check[0],
        "launches_per_step": counts[0], "launches": total,
        "expected_per_step": want}


def phase_profile_training(state):
    """One more training step under ``torch.profiler`` (``--profile``):
    the device's busy time by kernel over the step's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.models import llama

    params, opt_state, batch, cfg, tx = state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = llama.train_step(params, opt_state, batch,
                                                   cfg, tx, remat=False)
        float(loss)
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    return {"phase": "profile_training", "profiled_step_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "kernels_seen": len(device),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def summary(kernels, counts, path_adam):
    """One row per kernel; ``launches`` sums the serving and training
    paths' runs, ``launches_by_path`` splits them. ``path_adam`` is the
    training phase's check of its Adam launch on the packed slab."""
    def row(name, source, replaces, r, err, **extra):
        by_path = {path: c[name] for path, c in counts.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r.get("shape"),
                **extra}

    fwd = kernels["flash_attention_fwd"]
    rms = kernels["rms_norm_fwd"]
    bwd = kernels["flash_attention_bwd"]
    rbwd = kernels["rms_norm_bwd"]
    adam = kernels["fused_adam"]
    csrc = "apex_tpu_torch/ops/csrc/"
    # the plain and library times of the two flash backward rows are one
    # call each that computes dq, dk and dv together: count them once
    both = {k: bwd[k] for k in ("plain_ms", "library_ms")}
    covers = {"plain_covers": "dq+dk+dv", "library_covers": "dq+dk+dv"}
    # forwards at the serving path's longest prefill (512 tokens, 512 rows);
    # backwards and Adam at the training path's shapes
    return {"kernels": [
        row("flash_attention_fwd", csrc + "flash_fwd.cu",
            "apex_tpu/ops/flash_attention.py:65", fwd[2],
            max(x["max_abs_err"] for x in fwd)),
        row("rms_norm_fwd", csrc + "rms_norm.cu",
            "apex_tpu/ops/layer_norm.py:56", rms[1],
            max(x["max_abs_err"] for x in rms)),
        row("flash_attention_bwd_dq", csrc + "flash_bwd.cu",
            "apex_tpu/ops/flash_attention.py:261",
            dict(bwd["dq"], shape=bwd["shape"], **both),
            bwd["max_abs_err"]["dq"], **covers),
        row("flash_attention_bwd_dkv", csrc + "flash_bwd.cu",
            "apex_tpu/ops/flash_attention.py:322",
            dict(bwd["dkv"], shape=bwd["shape"], **both),
            max(bwd["max_abs_err"]["dk"], bwd["max_abs_err"]["dv"]),
            **covers),
        row("rms_norm_bwd", csrc + "rms_norm.cu",
            "apex_tpu/ops/layer_norm.py:189", rbwd,
            max(rbwd["max_abs_err"].values())),
        row("fused_adam", csrc + "fused_adam.cu",
            "apex_tpu/ops/fused_adam_kernel.py:35",
            dict(adam, shape=[adam["n"]]), adam["max_abs_err"]["delta"],
            path_max_abs_err=path_adam),
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
    profiling = "--profile" in sys.argv[1:]
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
        reset_counts()
        params, cfg, serving = phase_serving()
        emit(serving)
        if profiling:
            phase = "profile"
            emit(phase_profile(params, cfg))
        # the profile's timed scheduler methods close over the engine
        # that holds the serving params: a reference cycle, which only
        # the collector frees
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase = "training"
        reset_counts()
        *state, training = phase_training(dev)
        emit(training)
        if profiling:
            phase = "profile_training"
            emit(phase_profile_training(state))
        del state
    except Exception as exc:  # report which phase failed, then fail
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"[:2000]})
        return 1
    counts = {"serving": serving["launches"],
              "training": training["launches"]}
    emit({"kernel_counts": counts})
    emit(summary(kernels, counts, training["adam_path_check"]))
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
