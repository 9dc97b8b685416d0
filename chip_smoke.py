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
               (kernel, host call, plain version, library call, bound):
               the fp8 cast at the serving weight (column-major, as the
               fp8 GEMM takes it, and row-major), a prefill activation
               and an E5M2 cotangent (bit for bit), the long-row softmax
               passes at 32,768 keys (causal and padding-masked); the
               flash backward twice, the two calls bit for bit.
4. serving  -- Llama-3-8B at full width and depth, random bf16 weights
               from a seeded generator, served by ``ServingEngine`` over a
               16-request closed-loop trace; every launch counter must
               match the path's expected count, and a teacher-forced pass
               of the full ``forward`` must agree with the engine's tokens.
5. profile  -- only with ``--profile``: host time per prefill and decode
               step, the device's busy share and its time by kernel.
5a. serving_fp8 -- the same model and trace through ``ServingEngine(
               weight_mode="fp8")``: exact launches (448 fp8 casts a
               prefill or decode step: 224 row-major activations, 224
               column-major weights), the engine's weight scales equal
               to ones computed here, a teacher-forced check against a
               full-sequence fp8 forward built here from the plain
               functions, and the share of tokens equal to phase 4's.
5b. long_context -- ``FusedScaleMaskSoftmax`` forward and backward at
               32,768 keys (causal over GPT-2 345M's 16 heads and the
               last 2048 queries; a padding mask; causal with the padding
               mask): one stats and one apply launch a forward, none of
               the whole-row kernels, dx against fp32 autograd of the
               plain function.
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
               by kernel (after phases 8 and 9 too).
8. gpt2_training -- bench.py's GPT-2 345M step at full width and depth
               (random bf16 weights from a seeded generator), batch 8 x
               1024, ``loss_fn(remat=True, vocab_chunks=8)`` and tree-mode
               ``fused_adam(lr=1e-4)``: step-0 gradients against an fp32
               reference, then 3 ``train_step``s with exact launch counts
               (LayerNorm forward 97, backward 49, causal softmax 48 a
               step), finite and falling loss, step time, tokens/s, MFU
               and peak memory.
9. bert_training -- bench.py's BERT-base step (12 layers, h 768), batch
               8 x 512 with the 15% masking, plus a padding mask (each
               row's length drawn from the seed in [128, 512], row 0
               full) so that the masked softmax runs, ``fused_lamb(lr=
               1e-3)`` and remat: the same checks (LayerNorm forward 50,
               backward 26, masked softmax 24 a step), sequences/s.

The last lines are the per-kernel summary, the card line and the result
object ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the ``apex_tpu_torch`` package beside it, the script exits 1.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import subprocess
import sys
import time
import traceback
from functools import partial
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

# bench.py's GPT-2 345M step (bench.py:670-686): full width and depth
GPT2_BATCH = 8
GPT2_SEQ = 1024
GPT2_LR = 1e-4
GPT2_CHUNKS = 8

# bench.py's BERT-base step (bench.py:631-640), plus padding: each row's
# valid length is drawn in [BERT_MIN_LEN, BERT_SEQ], row 0 full
BERT_BATCH = 8
BERT_SEQ = 512
BERT_LR = 1e-3
BERT_MIN_LEN = 128

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

# the long-context softmax shapes: GPT-2 345M's 16 heads of 64, the last
# LONG_SQ queries of a LONG_SK-key context (causal), and a padded batch
# (each row's valid length drawn from the seed above _WHOLE_ROW_MAX_SK,
# row 0 full); bf16, 2 GiB each
LONG_SK = 32768
LONG_CAUSAL = (1, 16, 2048, LONG_SK)
LONG_MASKED = (2, 16, 1024, LONG_SK)
LONG_SCALE = 64 ** -0.5

# teacher-forced agreement: the engine's token at each generated
# position must have a logit within DELTA of that row's maximum under the
# full-sequence forward. Both sides run the same bf16 model through
# different shapes (a paged one-token decode vs one pass over the whole
# sequence), so bf16 rounding lands in different places; DELTA covers the
# logit spread between two such equal runs (measured below as
# ``spread``: the same positions through forward passes of two lengths),
# with room to spare. A wrong kernel or cache moves logits by O(1).
DELTA = 0.25
# the same check for the fp8 engine against a full-sequence fp8 forward
# written here from the plain functions (cast, upcast product, RMSNorm,
# attention). Both quantize every activation (scale 1) and weight (its
# static scale) to E4M3, whose grid step is 2^-3 of a value: an fp32 sum
# taken in another order, or a bf16 rounding landing elsewhere, moves an
# activation across an fp8 rounding boundary now and then, and that moves
# the logits by far more than a bf16 rounding does. DELTA_FP8 covers the
# logit spread between two equal fp8 runs (``spread``, measured as for
# DELTA: the prompt's positions through fp8 forward passes of two
# lengths; 0.453125 on the H100 in each of five runs, with a worst gap
# of 0.296875: same seed, same kernels, the same numbers), with room to
# spare; a wrong cast, scale or product moves the logits by O(1).
DELTA_FP8 = 1.0

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
    # no atomics: a second call gives the same bits
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, scale)
    torch.cuda.synchronize()
    for name, first, second in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        if not torch.equal(first, second):
            raise AssertionError(f"flash {name}: two calls differ")
    # bf16 outputs: both sides sum in fp32 (in other orders) and round
    # each value once to bf16 (2^-9 relative); the kernels also round P
    # and dS once to bf16 before their products (tensor-core operands).
    # |kernel - plain| stays within 1% of the output's largest value
    errs = {}
    for name, got, r, n in (("dq", dq, ref[0], H), ("dk", dk, ref[1], H_kv),
                            ("dv", dv, ref[2], H_kv)):
        r = r.reshape(b, n, s, d).transpose(1, 2)
        errs[name] = max_err(got, r, 1e-2, f"flash {name}")
    del dq, dk, dv, ref, again
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
           "max_abs_err": errs, "bit_identical_rerun": True, "pairs": pairs,
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


def check_layer_norm(dev):
    """LayerNorm forward and backward at GPT-2's rows (8 x 1024 tokens) x
    h 1024, eps 1e-5, and BERT's (8 x 512) x 768, eps 1e-12, bf16, with
    bf16 affine params."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    fwd, bwd = [], []
    for rows, h, eps in ((GPT2_BATCH * GPT2_SEQ, 1024, 1e-5),
                         (BERT_BATCH * BERT_SEQ, 768, 1e-12)):
        w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
            torch.bfloat16)
        b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(
            torch.bfloat16)

        def make():
            x, dy = (torch.randn(rows, h, generator=g, device="cuda").to(
                torch.bfloat16) for _ in range(2))
            _, mu, rstd = ln._ln_fwd_cuda(x, w, b, eps)
            return x, dy, mu, rstd

        x, dy, mu, rstd = make()
        y, mu_k, rstd_k = ln._ln_fwd_cuda(x, w, b, eps)
        y_ref, mu_ref, rstd_ref = ln._ln_fwd_plain(x, w, b, eps)
        got = ln._ln_bwd_cuda(x, w, mu, rstd, dy)
        ref = ln._ln_bwd_plain(x, w, mu, rstd, dy)
        torch.cuda.synchronize()
        # each output is an fp32 sum (over h, or over the rows for dw and
        # db) taken in another order and rounded once to bf16: within one
        # bf16 ulp (2^-8 relative) of the output's scale; mu and rstd are
        # that fp32 rounding
        err = max_err(y, y_ref, 8e-3, "layer_norm y")
        torch.testing.assert_close(mu_k, mu_ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rstd_k, rstd_ref, rtol=1e-5, atol=0)
        errs = {name: max_err(a, r, 8e-3, f"layer_norm {name}")
                for name, a, r in zip(("dx", "dw", "db"), got, ref)}
        del y, y_ref, got, ref
        fwd_bytes = 2 * rows * h * 2 + 2 * h * 2 + 2 * rows * 4
        bwd_bytes = 3 * rows * h * 2 + 2 * rows * 4 + 3 * h * 2
        sets = copies(make, bwd_bytes)

        def fwd_call(x, dy, mu, rstd):
            return ln._ln_fwd_cuda(x, w, b, eps)

        def fwd_plain(x, dy, mu, rstd):
            return ln._ln_fwd_plain(x, w, b, eps)

        def fwd_lib(x, dy, mu, rstd):
            return F.layer_norm(x, (h,), w, b, eps)

        def bwd_call(x, dy, mu, rstd):
            return ln._ln_bwd_cuda(x, w, mu, rstd, dy)

        def bwd_plain(x, dy, mu, rstd):
            return ln._ln_bwd_plain(x, w, mu, rstd, dy)

        graphs = []
        for x, dy, _, _ in sets:
            leaves = [t.detach().requires_grad_() for t in (x, w, b)]
            graphs.append((F.layer_norm(leaves[0], (h,), leaves[1],
                                        leaves[2], eps), leaves, dy))

        def bwd_lib(y, inputs, grad):
            return torch.autograd.grad(y, inputs, grad, retain_graph=True)

        ms = time_ms(fwd_call, sets)
        b_ms, b_by = bound(fwd_bytes, 8.0 * rows * h, dev["fp32_flops"], dev)
        fwd.append({"shape": [rows, h], "eps": eps, "dtype": "bfloat16",
                    "max_abs_err": err, "ms": ms,
                    "host_ms": host_ms(fwd_call, sets[0]),
                    "plain_ms": time_ms(fwd_plain, sets),
                    "library_ms": time_ms(fwd_lib, sets),
                    "library": "F.layer_norm", "bound_ms": b_ms,
                    "bound_by": b_by})
        ms = time_ms(bwd_call, sets)
        b_ms, b_by = bound(bwd_bytes, 14.0 * rows * h, dev["fp32_flops"],
                           dev)
        bwd.append({"shape": [rows, h], "eps": eps, "dtype": "bfloat16",
                    "max_abs_err": errs, "ms": ms,
                    "host_ms": host_ms(bwd_call, sets[0]),
                    "plain_ms": time_ms(bwd_plain, sets),
                    "library_ms": time_ms(bwd_lib, graphs),
                    "library": "backward of F.layer_norm, dx+dw+db",
                    "bound_ms": b_ms, "bound_by": b_by})
        del sets, graphs
    return fwd, bwd


def bert_pad_mask(gen, batch, seq):
    """[batch, seq] bool on the card, True = padding: row i valid for a
    length drawn uniformly in [BERT_MIN_LEN, seq], row 0 for all of it."""
    import torch

    lengths = torch.randint(min(BERT_MIN_LEN, seq), seq + 1, (batch,),
                            generator=gen, device="cuda")
    lengths[0] = seq
    return torch.arange(seq, device="cuda")[None, :] >= lengths[:, None]


def check_softmax(dev):
    """The causal kernel at GPT-2's scores [8 x 16 heads, 1024, 1024] and
    the masked kernel at BERT's [8, 12 heads, 512, 512] with a [8, 1, 1,
    512] padding mask, bf16, scale 1/8. The library yardstick is
    torch.softmax(x.float() * scale) on an input already masked: it
    leaves out the mask fill and writes fp32, not bf16."""
    import torch

    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    scale = 0.125
    out = {}
    for name, shape in (("causal", (GPT2_BATCH * 16, GPT2_SEQ, GPT2_SEQ)),
                        ("masked", (BERT_BATCH, 12, BERT_SEQ, BERT_SEQ))):
        if name == "causal":
            mask = sm._causal_mask(shape[-2], shape[-1], "cuda")
            call = partial(sm._causal_cuda, scale=scale)
            plain = partial(sm._causal_plain, scale=scale)
        else:
            mask = bert_pad_mask(g, BERT_BATCH, BERT_SEQ)[:, None, None, :]
            call = partial(sm._masked_cuda, mask=mask, scale=scale)
            plain = partial(sm._masked_plain, mask=mask, scale=scale)

        def make():
            return (4 * torch.randn(shape, generator=g, device="cuda")).to(
                torch.bfloat16)

        x = make()
        y, ref = call(x), plain(x)
        torch.cuda.synchronize()
        # each output is exp(s - max) / sum, rounded once to bf16: within
        # one bf16 ulp (2^-8 relative) of itself
        torch.testing.assert_close(y.float(), ref.float(), rtol=8e-3,
                                   atol=1e-6)
        err = float((y.float() - ref.float()).abs().max())
        del x, y, ref
        numel = math.prod(shape)
        # the function needs x only where it is unmasked (a masked
        # element's output is exp(-10000 - max) / sum whatever x holds),
        # and writes all of y; the padding mask is read once, the causal
        # one computed
        kept = int((~mask).expand(shape).sum())
        nbytes = kept * 2 + numel * 2 + (mask.numel() if name == "masked"
                                         else 0)
        sets = [(x,) for x in copies(make, 2 * numel * 2)]
        premasked = [(x.masked_fill(mask, -10000.0 / scale),)
                     for (x,) in sets]

        def library(x):
            return torch.softmax(x.float() * scale, dim=-1)

        ms = time_ms(call, sets)
        b_ms, b_by = bound(nbytes, 6.0 * kept, dev["fp32_flops"], dev)
        out[name] = {"shape": list(shape), "dtype": "bfloat16",
                     "scale": scale, "unmasked": kept, "bytes": nbytes,
                     "max_abs_err": err, "ms": ms,
                     "host_ms": host_ms(call, sets[0]),
                     "plain_ms": time_ms(plain, sets, iters=5),
                     "library_ms": time_ms(library, premasked, iters=5),
                     "library": "torch.softmax(x.float() * scale) on a "
                                "pre-masked x: no mask fill, fp32 output",
                     "bound_ms": b_ms, "bound_by": b_by}
        del sets, premasked
    return out


def assert_fp8_equal(y, ref, what: str) -> None:
    """fp8 outputs equal bit for bit where finite, NaN at the same
    places (the encoding of NaN is not compared)."""
    import torch

    nan, nan_ref = torch.isnan(y.float()), torch.isnan(ref.float())
    if not (torch.equal(nan, nan_ref) and torch.equal(
            y.view(torch.uint8)[~nan], ref.view(torch.uint8)[~nan_ref])):
        differ = int((y.view(torch.uint8) != ref.view(torch.uint8)).sum())
        raise AssertionError(f"{what}: {differ} fp8 values differ from the "
                             f"plain version")


def check_fp8_cast(dev):
    """The cast kernels at the fp8 serving path's shapes: a Llama-3-8B
    gate weight [4096, 14336] at its static E4M3 scale through the
    column-major kernel (the path's) and, for comparison, the row-major
    one; a 512-token prefill activation [512, 4096] at scale 1 with some
    |x| > 448 (saturation), and an E5M2 cotangent-shaped [512, 14336].
    y must equal the plain version bit for bit and amax exactly. No one
    PyTorch call computes the fused cast and amax: library_ms is null."""
    import torch

    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2

    def weight():
        return (torch.randn(4096, 14336, generator=g, device="cuda")
                * 4096 ** -0.5).to(torch.bfloat16)

    def activation():
        x = 30 * torch.randn(512, 4096, generator=g, device="cuda")
        x[:, ::97] *= 40  # ~1% of the values past E4M3's 448
        return x.to(torch.bfloat16)

    def cotangent():
        return (1e-3 * torch.randn(512, 14336, generator=g, device="cuda")
                ).to(torch.bfloat16)

    out = {}
    for name, make, fp8, fmax, col in (
            ("weight", weight, e4m3, 448.0, True),
            ("weight_row_major", weight, e4m3, 448.0, False),
            ("activation", activation, e4m3, 448.0, False),
            ("cotangent", cotangent, e5m2, 57344.0, False)):
        x = make()
        amax_x = torch.amax(torch.abs(x)).float()
        # the static (weight) or delayed (cotangent) scale of the path
        scale = (torch.full_like(amax_x, fmax) / amax_x if name != "activation"
                 else torch.ones((), device="cuda"))
        y, amax = fc._cast_and_scale_cuda(x, scale, fp8, fmax, col)
        y_ref, amax_ref = fc._cast_and_scale_plain(x, scale, fp8, fmax, col)
        torch.cuda.synchronize()
        if y.stride() != y_ref.stride():
            raise AssertionError(f"fp8 cast {name}: strides {y.stride()} "
                                 f"!= {y_ref.stride()}")
        assert_fp8_equal(y, y_ref, f"fp8 cast {name}")
        if float(amax) != float(amax_ref):
            raise AssertionError(f"fp8 cast {name}: amax {float(amax)} != "
                                 f"{float(amax_ref)}")
        saturated = int((x.float() * scale).abs().gt(fmax).sum())
        del y, y_ref
        n = x.numel()
        nbytes = n * (x.element_size() + 1)
        sets = [(a,) for a in copies(make, nbytes)]

        def call(a):
            return fc._cast_and_scale_cuda(a, scale, fp8, fmax, col)

        def plain(a):
            return fc._cast_and_scale_plain(a, scale, fp8, fmax, col)

        ms = time_ms(call, sets)
        b_ms, b_by = bound(nbytes, 3.0 * n, dev["fp32_flops"], dev)
        out[name] = {"shape": list(x.shape), "dtype": "bfloat16",
                     "fp8": str(fp8).split(".")[-1], "col_major": col,
                     "scale": float(scale), "amax": float(amax),
                     "saturated": saturated, "bytes": nbytes,
                     "max_abs_err": 0.0, "bit_identical": True, "ms": ms,
                     "host_ms": host_ms(call, sets[0]),
                     "plain_ms": time_ms(plain, sets, iters=5),
                     "library_ms": None,
                     "library": "none: no one PyTorch call casts and takes "
                                "the amax",
                     "bound_ms": b_ms, "bound_by": b_by}
        del sets, x
    return out


def check_fp8_matmul(dev):
    """The fp8 serving product, ``precision.matmul_fp8`` (the activation's
    row-major cast, the weight's column-major cast, ``torch._scaled_mm``
    with an fp32 result, the scale-out), beside the bf16 product it
    replaces, at the gate projection [4096, 14336] of a decode step (8
    rows) and of a 512-token prefill: the whole call's device and host
    ms, and each piece's device ms. ``weight_row_cast_and_copy_ms`` is
    the earlier way to the same operand (a row-major cast, then a copy
    into the column-major layout), timed in the same run. The fp8 GEMM
    is held against the plain upcast product of the same fp8 operands
    (fp32 sums in another order)."""
    import torch

    from apex_tpu_torch.ops import fp8_cast_kernel as fc
    from apex_tpu_torch.ops import precision

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    e4m3 = torch.float8_e4m3fn
    w = (torch.randn(4096, 14336, generator=g, device="cuda")
         * 4096 ** -0.5).to(torch.bfloat16)
    amax = torch.amax(torch.abs(w)).float()
    scale = torch.full_like(amax, 448.0) / amax
    b8, _ = fc._cast_and_scale_cuda(w, scale, e4m3, 448.0, True)
    one = torch.ones((), device="cuda")

    def row_cast_and_copy(b):
        b8_row, _ = fc._cast_and_scale_cuda(b, scale, e4m3, 448.0)
        return b8_row.t().contiguous()

    out = {}
    for rows in (MAX_BATCH, MAX_PROMPT):
        x = torch.randn(rows, 4096, generator=g, device="cuda").to(
            torch.bfloat16)
        a8, _ = fc._cast_and_scale_cuda(x, 1.0, e4m3, 448.0)
        acc = precision._fp8_product(a8, b8)
        ref = precision._product_upcast(a8, b8)
        err = max_err(acc, ref, 1e-3, f"fp8 GEMM at {rows} rows")

        def fp8_call(a):
            return precision.matmul_fp8(a, w, 1.0, scale)

        out[f"rows_{rows}"] = {
            "shape": [rows, 4096, 14336], "max_abs_err": err,
            "bf16_ms": time_ms(lambda a: torch.matmul(a, w), [(x,)]),
            "fp8_call_ms": time_ms(fp8_call, [(x,)]),
            "fp8_call_host_ms": host_ms(fp8_call, (x,)),
            "bf16_host_ms": host_ms(lambda a: torch.matmul(a, w), (x,)),
            "activation_cast_ms": time_ms(
                lambda a: fc._cast_and_scale_cuda(a, 1.0, e4m3, 448.0),
                [(x,)]),
            "weight_cast_ms": time_ms(
                lambda b: fc._cast_and_scale_cuda(b, scale, e4m3, 448.0,
                                                  True),
                [(w,)]),
            "weight_row_cast_and_copy_ms": time_ms(row_cast_and_copy,
                                                   [(w,)]),
            "scaled_mm_ms": time_ms(
                lambda a, b: torch._scaled_mm(a, b, scale_a=one,
                                              scale_b=one,
                                              out_dtype=torch.float32),
                [(a8, b8)])}
    return out


def long_pad_mask(gen, batch):
    """[batch, 1, 1, LONG_SK] bool on the card, True = padding: row 0
    full, the others valid for a length drawn in (16384, LONG_SK]."""
    import torch

    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    lengths = torch.randint(sm._WHOLE_ROW_MAX_SK + 1, LONG_SK + 1, (batch,),
                            generator=gen, device="cuda")
    lengths[0] = LONG_SK
    mask = torch.arange(LONG_SK, device="cuda")[None, :] >= lengths[:, None]
    return mask[:, None, None, :], lengths.tolist()


def check_long_softmax(dev):
    """The stats and apply kernels at 32,768 keys against their plain
    versions (the two passes over blocks of 2048 keys): causal
    LONG_CAUSAL and padding-masked LONG_MASKED, bf16. m must be equal, l
    within fp32 rounding of a sum taken in another order, y within one
    bf16 ulp. The library yardstick is torch.softmax of a pre-scaled,
    pre-masked fp32 copy (no mask fill, fp32 output)."""
    import torch

    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = {}
    for name, shape in (("causal", LONG_CAUSAL), ("masked", LONG_MASKED)):
        if name == "causal":
            mask, lengths = None, None
            full = sm._causal_mask(shape[-2], shape[-1], "cuda")
        else:
            mask, lengths = long_pad_mask(g, shape[0])
            full = mask
        causal = mask is None
        x = (4 * torch.randn(shape, generator=g, device="cuda")).to(
            torch.bfloat16)
        m, l = sm._stats_cuda(x, mask, LONG_SCALE)
        y = sm._apply_cuda(x, mask, LONG_SCALE, m, l)
        m_ref, l_ref = sm._stats_plain(x, mask, LONG_SCALE, causal)
        y_ref = sm._apply_plain(x, mask, LONG_SCALE, causal, m_ref, l_ref)
        torch.cuda.synchronize()
        torch.testing.assert_close(m, m_ref, rtol=0, atol=0)
        # l: a sum of 32,768 fp32 terms in another order
        torch.testing.assert_close(l, l_ref, rtol=2e-5, atol=0)
        # each y is exp(s - m) / l rounded once to bf16: one bf16 ulp
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=8e-3,
                                   atol=1e-6)
        errs = {"m": 0.0, "l": float((l - l_ref).abs().max()),
                "y": float((y.float() - y_ref.float()).abs().max())}
        del y, y_ref, m_ref, l_ref
        numel = math.prod(shape)
        rows = numel // shape[-1]
        kept = int((~full).expand(shape).sum())
        mask_bytes = 0 if mask is None else mask.numel()
        # each pass needs x only where unmasked; stats writes m and l,
        # apply reads them and writes all of y; the function as a whole
        # (one pass's reads and apply's writes) bounds the pair
        stats_bytes = kept * 2 + mask_bytes + rows * 8
        apply_bytes = kept * 2 + mask_bytes + rows * 8 + numel * 2
        pair_bytes = kept * 2 + mask_bytes + numel * 2
        sets = [(x,)]  # 2 GiB: far beyond L2

        def stats(a):
            return sm._stats_cuda(a, mask, LONG_SCALE)

        def apply(a):
            return sm._apply_cuda(a, mask, LONG_SCALE, m, l)

        def stats_plain(a):
            return sm._stats_plain(a, mask, LONG_SCALE, causal)

        def apply_plain(a):
            return sm._apply_plain(a, mask, LONG_SCALE, causal, m, l)

        res = {"shape": list(shape), "dtype": "bfloat16",
               "scale": LONG_SCALE, "lengths": lengths, "unmasked": kept,
               "max_abs_err": errs,
               "pair_bytes": pair_bytes,
               "pair_bound_ms": bound(pair_bytes, 0, 1, dev)[0]}
        for part, call, plain, nbytes, flops in (
                ("stats", stats, stats_plain, stats_bytes, 5.0 * kept),
                ("apply", apply, apply_plain, apply_bytes, 5.0 * numel)):
            b_ms, b_by = bound(nbytes, flops, dev["fp32_flops"], dev)
            # the plain passes launch hundreds of small ops a call, more
            # than the spin can hold queued: their time is the
            # synchronised wall time of a call
            res[part] = {"ms": time_ms(call, sets),
                         "host_ms": host_ms(call, sets[0]),
                         "plain_ms": host_ms(plain, sets[0], iters=3),
                         "plain_timed": "host",
                         "bytes": nbytes, "bound_ms": b_ms,
                         "bound_by": b_by}
        premasked = (x.float() * LONG_SCALE).masked_fill(full, -10000.0)
        res["library_ms"] = time_ms(
            lambda a: torch.softmax(a, dim=-1), [(premasked,)], iters=5)
        res["library"] = ("torch.softmax of a pre-scaled, pre-masked fp32 "
                          "copy: no mask fill, fp32 output")
        out[name] = res
        del premasked, x, m, l, sets
        torch.cuda.empty_cache()
    return out


def phase_kernels(dev):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ln_fwd, ln_bwd = check_layer_norm(dev)
    softmax = check_softmax(dev)
    long_softmax = check_long_softmax(dev)
    out = {"phase": "kernels", "fp8_cast": check_fp8_cast(dev),
           "fp8_matmul": check_fp8_matmul(dev),
           "fused_softmax_long": long_softmax,
           "rms_norm_fwd": check_rms(dev),
           "flash_attention_fwd": check_flash(dev),
           "flash_attention_bwd": check_flash_bwd(dev),
           "rms_norm_bwd": check_rms_bwd(dev),
           "fused_adam": check_adam(dev),
           "layer_norm_fwd": ln_fwd, "layer_norm_bwd": ln_bwd,
           "fused_softmax_causal": softmax["causal"],
           "fused_softmax_masked": softmax["masked"]}
    torch.cuda.empty_cache()
    return out


def teacher_forced(forward, engine, rids, delta):
    """Re-run the engine's requests through ``forward(tokens [1, s]) ->
    logits [1, s, vocab]`` over the whole sequence and measure each
    generated token's logit gap to its row's maximum."""
    import torch

    device = engine.device
    worst, exact, total, spread = 0.0, 0, 0, 0.0
    for rid in rids:
        res = engine.results[rid]
        prompt, toks = res["prompt"], res["tokens"]
        p = len(prompt)
        seq = torch.tensor([prompt + toks[:-1]], device=device)
        logits = forward(seq)[0]
        rows = logits[p - 1:p - 1 + len(toks)]
        picked = rows.gather(1, torch.tensor(toks, device=device)[:, None])
        gap = (rows.max(dim=1).values - picked[:, 0]).cpu()
        worst = max(worst, float(gap.max()))
        exact += int((gap == 0).sum())
        total += len(toks)
        # two equal runs: the prompt's positions through a forward of the
        # prompt alone
        short = forward(seq[:, :p])[0]
        spread = max(spread, float((short - logits[:p]).abs().max()))
        del logits, short
    out = {"requests": list(rids), "positions": total,
           "worst_gap": worst, "exact_argmax": exact, "spread": spread,
           "delta": delta}
    if worst > delta or spread > delta:
        raise AssertionError(f"teacher-forced check failed: {out}")
    return out


def make_engine(params, cfg, weight_mode="native"):
    """The serving geometry: 8 slots and the pages of 8 worst-case
    requests."""
    from apex_tpu_torch.serving import ServingEngine, pages_per_request

    num_pages = MAX_BATCH * pages_per_request(MAX_PROMPT, MAX_NEW,
                                              PAGE_SIZE)
    return ServingEngine(params, cfg, num_pages=num_pages,
                         page_size=PAGE_SIZE, max_batch=MAX_BATCH,
                         max_prompt_len=MAX_PROMPT, max_new_cap=MAX_NEW,
                         weight_mode=weight_mode)


def fp8_weight_scale(w):
    """A weight's static E4M3 scale, computed here apart from the
    program's ``fp8_weight_scales``: 448 / max(max|w|, 1e-12) in fp32,
    a division of tensors (one rounding)."""
    import torch

    amax = torch.clamp(torch.amax(torch.abs(w.float())), min=1e-12)
    return torch.full_like(amax, 448.0) / amax


def fp8_forward(params, tokens, cfg):
    """Full-sequence logits of the fp8 serving model through the plain
    functions, written out apart from the model code: each of a layer's
    7 products casts its activation (scale 1) and its weight (its static
    scale, :func:`fp8_weight_scale`) with the cast's plain version,
    multiplies the fp8 values upcast to fp32 (exact) and scales out to
    bf16; RMSNorm and attention are the plain versions, the lm head a
    bf16 matmul, as in the engine."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.models import llama
    from apex_tpu_torch.ops.flash_attention import _reference_attention
    from apex_tpu_torch.ops.fp8_cast_kernel import _cast_and_scale_plain
    from apex_tpu_torch.ops.layer_norm import _rms_fwd_plain
    from apex_tpu_torch.transformer.functional.rope import apply_rotary_qk

    e4m3 = torch.float8_e4m3fn

    def mm(x, w):
        s = fp8_weight_scale(w)
        a8, _ = _cast_and_scale_plain(x, 1.0, e4m3, 448.0)
        b8, _ = _cast_and_scale_plain(w, s, e4m3, 448.0)
        return ((a8.float() @ b8.float()) * torch.reciprocal(s)).to(x.dtype)

    def norm(x, w):
        y, _ = _rms_fwd_plain(x.reshape(-1, x.shape[-1]), w, cfg.rms_eps)
        return y.reshape(x.shape)

    def heads_major(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])

    b, s = tokens.shape
    d = cfg.head_dim
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens]
    with torch.no_grad():
        for idx in range(cfg.num_layers):
            lp = llama.layer(params, idx)
            h = norm(x, lp["attn_norm"])
            q, k, v = (mm(h, lp[n]).reshape(b, s, -1, d)
                       for n in ("wq", "wk", "wv"))
            q, k = apply_rotary_qk(q, k, positions=positions,
                                   base=cfg.rope_theta)
            o = _reference_attention(heads_major(q), heads_major(k),
                                     heads_major(v), True, d ** -0.5)
            o = o.reshape(b, -1, s, d).transpose(1, 2).reshape(b, s, -1)
            x = x + mm(o, lp["wo"])
            h = norm(x, lp["mlp_norm"])
            x = x + mm(F.silu(mm(h, lp["wg"])) * mm(h, lp["wu"]), lp["wd"])
        return (norm(x, params["final_norm"]) @ params["lm_head"]).float()


def serving_report(engine, report, counts, want, peak):
    """The end-to-end numbers of a served trace, and a SHA-1 of its tokens
    by request id: equal digests mean equal tokens, so a later run can
    show that a path's tokens did not move."""
    tokens = {rid: res["tokens"]
              for rid, res in sorted(engine.results.items())}
    return {"tokens_sha1": hashlib.sha1(
                json.dumps(tokens).encode()).hexdigest(),
            "num_pages": engine.scheduler.cache.num_pages,
            "page_size": PAGE_SIZE, "max_batch": MAX_BATCH,
            "requests": report["requests"], "tokens": report["tokens"],
            "wall_s": report["wall_s"],
            "tokens_per_s": report["tokens_per_s"],
            "ttft_p50_ms": report["ttft_p50_ms"],
            "ttft_p99_ms": report["ttft_p99_ms"],
            "latency_p50_ms": report["latency_p50_ms"],
            "latency_p99_ms": report["latency_p99_ms"],
            "mean_occupancy": report["mean_occupancy"],
            "prefills": engine.scheduler.prefill_count,
            "decode_steps": engine.scheduler.decode_steps,
            "peak_memory_bytes": peak, "launches": counts,
            "expected_launches": want}


def serve(params, cfg, weight_mode):
    """The 16-request trace through a fresh engine: (engine, report,
    launch counts, expected counts, peak memory). Every request must get
    its full token count and the counts must be exact."""
    import torch

    from apex_tpu_torch.serving import make_trace, run_closed_loop

    engine = make_engine(params, cfg, weight_mode)
    trace = make_trace(**TRACE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    report = run_closed_loop(engine, trace, use_wall_clock=False)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    prefills = engine.scheduler.prefill_count
    calls = prefills + engine.scheduler.decode_steps
    # no gradients while serving: the backward and Adam kernels stay at 0;
    # fp8 casts each product's activation (row-major) and weight
    # (column-major): 7 x L of each a call
    want = dict({k: 0 for k in counts},
                flash_attention_fwd=cfg.num_layers * prefills,
                rms_norm_fwd=(2 * cfg.num_layers + 1) * calls)
    if weight_mode == "fp8":
        want["fp8_cast"] = want["fp8_cast_col"] = 7 * cfg.num_layers * calls
    missing = [t.rid for t in trace
               if len(engine.results.get(t.rid, {}).get("tokens", ()))
               != t.max_new_tokens]
    if missing or len(engine.results) != len(trace):
        raise AssertionError(f"requests without their full token count: "
                             f"{missing}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    return engine, trace, serving_report(engine, report, counts, want, peak)


def phase_serving():
    import torch

    from apex_tpu_torch.models import llama

    cfg = llama.llama3_8b()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    engine, trace, report = serve(params, cfg, "native")
    longest = sorted(trace, key=lambda t: (-len(t.prompt), t.rid))
    tf = teacher_forced(lambda seq: llama.forward(params, seq, cfg), engine,
                        [longest[0].rid, longest[-1].rid], DELTA)
    return params, cfg, engine.results, {
            "phase": "serving", "model": "llama3_8b", "dtype": "bfloat16",
            "num_layers": cfg.num_layers, "init_s": init_s, **report,
            "teacher_forced": tf}


def phase_serving_fp8(params, cfg, native_results):
    """The serving phase's model and trace with weight_mode="fp8"."""
    import torch

    from apex_tpu_torch.serving import fp8_weight_scales

    t0 = time.monotonic()
    scales = fp8_weight_scales(params)
    torch.cuda.synchronize()
    scales_s = time.monotonic() - t0
    # the program's scales against ones computed here, layer by layer
    for name, got in scales.items():
        ref = torch.stack([fp8_weight_scale(w) for w in params["layers"][name]])
        if not torch.equal(got, ref):
            raise AssertionError(f"fp8 weight scales of {name}: worst "
                                 f"{float((got - ref).abs().max())} off")
    engine, trace, report = serve(params, cfg, "fp8")
    longest = sorted(trace, key=lambda t: (-len(t.prompt), t.rid))
    tf = teacher_forced(lambda seq: fp8_forward(params, seq, cfg),
                        engine, [longest[0].rid, longest[-1].rid],
                        DELTA_FP8)
    # for information only: fp8 rounds every operand, so greedy tokens
    # part from the native run's after the first difference
    same = total = 0
    for rid, res in engine.results.items():
        ref = native_results[rid]["tokens"]
        same += sum(a == b for a, b in zip(res["tokens"], ref))
        total += len(ref)
    return {"phase": "serving_fp8", "model": "llama3_8b",
            "weight_mode": "fp8", "dtype": "bfloat16",
            "num_layers": cfg.num_layers, "weight_scales_s": scales_s,
            "weight_scales_equal": True,
            **report, "teacher_forced": tf,
            "tokens_equal_to_native": same, "tokens_compared": total,
            "share_equal_to_native": same / total}


def phase_long_context(dev):
    """FusedScaleMaskSoftmax forward and backward at 32,768 keys: causal
    at LONG_CAUSAL, a padding mask at LONG_MASKED, and causal with that
    padding mask. Each forward launches exactly one stats and one apply
    kernel and no whole-row kernel, the backward none; dx is held against
    fp32 autograd of the plain function on the same x and g."""
    import torch

    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    pad, lengths = long_pad_mask(g, LONG_MASKED[0])
    out = {"phase": "long_context", "scale": LONG_SCALE, "lengths": lengths}
    for name, shape, mask_type, mask in (
            ("causal", LONG_CAUSAL, AttnMaskType.causal, None),
            ("padding", LONG_MASKED, AttnMaskType.padding, pad),
            ("causal_padding", LONG_MASKED, AttnMaskType.causal, pad)):
        module = FusedScaleMaskSoftmax(attn_mask_type=mask_type,
                                       scale=LONG_SCALE)
        x = (4 * torch.randn(shape, generator=g, device="cuda")).to(
            torch.bfloat16).requires_grad_()
        dy = torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
        reset_counts()
        y = module(x, mask)
        counts = read_counts()
        (dx,) = torch.autograd.grad(y, x, dy)
        torch.cuda.synchronize()
        want = dict({k: 0 for k in counts}, fused_softmax_stats=1,
                    fused_softmax_apply=1)
        if counts != want or read_counts() != want:
            raise AssertionError(f"{name}: launches {counts}, after the "
                                 f"backward {read_counts()} != {want}")
        # the plain function in fp32 with ordinary autograd
        full = (sm._causal_mask(shape[-2], shape[-1], "cuda")
                if mask is None else mask)
        if mask_type == AttnMaskType.causal and mask is not None:
            full = mask | sm._causal_mask(shape[-2], shape[-1], "cuda")
        x32 = x.detach().float().requires_grad_()
        y32 = sm._masked_plain(x32, full, LONG_SCALE)
        (dx32,) = torch.autograd.grad(y32, x32, dy.float())
        # y and dx in bf16 from bf16 y: within 1% of each output's
        # largest value (a bf16 rounding of y feeds dx)
        errs = {"y": max_err(y.detach(), y32.detach(), 1e-2, f"{name} y"),
                "dx": max_err(dx, dx32, 1e-2, f"{name} dx")}
        del y32, dx32, x32, y, dx
        torch.cuda.empty_cache()

        def fwd(a):
            return module(a, mask)

        y = module(x, mask)

        def bwd(a):
            return torch.autograd.grad(y, a, dy, retain_graph=True)

        # host ms: synchronised wall time of a call, as a caller pays it
        out[name] = {"shape": list(shape), "mask_type": mask_type.name,
                     "mask": None if mask is None else list(mask.shape),
                     "launches": counts, "max_abs_err": errs,
                     "dx_rel_tol": 1e-2,
                     "forward_ms": host_ms(fwd, (x,), iters=5),
                     "backward_ms": host_ms(bwd, (x,), iters=5)}
        del y, x, dy
        torch.cuda.empty_cache()
    return out


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


def grad_check(params, kernel_loss, plain_loss):
    """Per-leaf relative L2 error and cosine of the step-0 gradients of
    ``kernel_loss`` (the kernel path) against ``plain_loss`` (the plain
    functions with ordinary autograd) on fp32 copies of the params, with
    ``plain_loss`` on the same bf16 params as the rounding floor."""
    import torch

    from apex_tpu_torch import _tree

    leaf_paths = _tree.paths(params)

    def grads_of(loss_of, tree):
        live = _tree.map_leaves(lambda t: t.detach().requires_grad_(), tree)
        loss = loss_of(live)
        grads = torch.autograd.grad(loss, _tree.leaves(live))
        return float(loss.detach()), list(grads)

    loss, kernel = grads_of(kernel_loss, params)
    loss32, ref = grads_of(plain_loss,
                           _tree.map_leaves(lambda t: t.float(), params))
    loss16, plain = grads_of(plain_loss, params)
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
    from apex_tpu_torch.ops import fp8_cast_kernel as fc
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    ln.launches = ln.bwd_launches = fak.launches = 0
    ln.ln_launches = ln.ln_bwd_launches = 0
    sm.causal_launches = sm.masked_launches = 0
    sm.stats_launches = sm.apply_launches = 0
    fc.launches = fc.col_launches = 0


def read_counts():
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_cast_kernel as fc
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.transformer.functional import fused_softmax as sm

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "rms_norm_fwd": ln.launches, "rms_norm_bwd": ln.bwd_launches,
            "fused_adam": fak.launches,
            "layer_norm_fwd": ln.ln_launches,
            "layer_norm_bwd": ln.ln_bwd_launches,
            "fused_softmax_causal": sm.causal_launches,
            "fused_softmax_masked": sm.masked_launches,
            "fused_softmax_stats": sm.stats_launches,
            "fused_softmax_apply": sm.apply_launches,
            "fp8_cast": fc.launches, "fp8_cast_col": fc.col_launches}


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

    grads = grad_check(params,
                       lambda t: llama.loss_fn(t, batch, cfg, remat=False),
                       lambda t: reference_loss(t, *batch, cfg))
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
    want = dict({k: 0 for k in total}, flash_attention_fwd=L,
                flash_attention_bwd_dq=L, flash_attention_bwd_dkv=L,
                rms_norm_fwd=2 * L + 1, rms_norm_bwd=2 * L + 1,
                fused_adam=1)
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
    def step():
        nonlocal params, opt_state
        params, opt_state, loss = llama.train_step(params, opt_state, batch,
                                                   cfg, tx, remat=False)
        return loss

    return step, {
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


def profile_step(phase: str, step):
    """One more training step, ``step() -> loss``, under ``torch.profiler``
    (``--profile``): the device's busy time by kernel over the step's host
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step())
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    return {"phase": phase, "profiled_step_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "kernels_seen": len(device),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def plain_ln(eps):
    """LayerNorm through its plain version, for the plain-autograd
    references."""
    from apex_tpu_torch.ops.layer_norm import _ln_fwd_plain

    def ln(x, w, b):
        y, _, _ = _ln_fwd_plain(x.reshape(-1, x.shape[-1]), w, b, eps)
        return y.reshape(x.shape)

    return ln


def mean_nll(logits, targets, weights=None):
    """Log-softmax CE of fp32 logits, averaged over the tokens or, with
    ``weights``, over their weighted sum (bert's loss mask)."""
    import torch

    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if weights is None:
        return nll.mean()
    return torch.sum(nll * weights) / torch.clamp(torch.sum(weights),
                                                  min=1.0)


def plain_attention(x, lp, num_heads, softmax):
    """Packed-qkv attention written out with plain torch ops, apart from
    the model code: wqkv [h, 3, h] split by its middle axis, heads of
    h / num_heads, ``softmax(scores, scale)`` over [b, n, s, s]."""
    import torch

    b, s, h = x.shape
    d = h // num_heads
    qkv = torch.einsum("bsh,hcj->bscj", x, lp["wqkv"]) + lp["bqkv"]
    q, k, v = (qkv[:, :, i].reshape(b, s, num_heads, d).permute(0, 2, 1, 3)
               for i in range(3))
    probs = softmax(q @ k.transpose(-1, -2), d ** -0.5).to(v.dtype)
    o = (probs @ v).permute(0, 2, 1, 3).reshape(b, s, h)
    return o @ lp["wo"] + lp["bo"]


def plain_mlp(x, lp, act):
    return act(x @ lp["wfc"] + lp["bfc"]) @ lp["wproj"] + lp["bproj"]


def plain_stack(x, layers, num_layers, layer):
    """Each layer of the stacked [L, ...] weights in turn, recomputed in
    the backward (torch.utils.checkpoint, non-reentrant) so that an fp32
    copy of the model fits beside the bf16 one."""
    from torch.utils.checkpoint import checkpoint

    for idx in range(num_layers):
        lp = {name: w[idx] for name, w in layers.items()}
        x = checkpoint(layer, x, lp, use_reentrant=False)
    return x


def gpt2_plain_loss(params, batch, cfg):
    """The GPT-2 loss through the port's plain functions (_ln_fwd_plain,
    _causal_plain), attention and MLP written out here rather than taken
    from the model code, ordinary autograd, and the full logits with a
    log-softmax CE."""
    import torch.nn.functional as F

    from apex_tpu_torch.transformer.functional.fused_softmax import (
        _causal_plain,
    )

    tokens, targets = batch
    ln = plain_ln(cfg.ln_eps)

    def layer(x, lp):
        x = x + plain_attention(ln(x, lp["ln1_w"], lp["ln1_b"]), lp,
                                cfg.num_heads, _causal_plain)
        return x + plain_mlp(ln(x, lp["ln2_w"], lp["ln2_b"]), lp,
                             lambda y: F.gelu(y, approximate="tanh"))

    x = params["embed"][tokens] + params["pos_embed"][None, :tokens.shape[1]]
    x = plain_stack(x, params["layers"], cfg.num_layers, layer)
    x = ln(x, params["lnf_w"], params["lnf_b"])
    return mean_nll(x @ params["embed"].T, targets)


def bert_plain_loss(params, batch, cfg, pad_mask):
    """The BERT MLM loss through the port's plain functions
    (_ln_fwd_plain, _masked_plain), attention and MLP written out here,
    and ordinary autograd."""
    import torch.nn.functional as F

    from apex_tpu_torch.transformer.functional.fused_softmax import (
        _masked_plain,
    )

    tokens, targets, loss_mask = batch
    ln = plain_ln(cfg.ln_eps)
    mask = pad_mask[:, None, None, :]

    def softmax(scores, scale):
        return _masked_plain(scores, mask, scale)

    def layer(x, lp):
        x = ln(x + plain_attention(x, lp, cfg.num_heads, softmax),
               lp["ln1_w"], lp["ln1_b"])
        return ln(x + plain_mlp(x, lp, F.gelu), lp["ln2_w"], lp["ln2_b"])

    x = (params["embed"][tokens] + params["pos_embed"][None, :tokens.shape[1]]
         + params["type_embed"][0])
    x = ln(x, params["emb_ln_w"], params["emb_ln_b"])
    x = plain_stack(x, params["layers"], cfg.num_layers, layer)
    x = ln(F.gelu(x @ params["mlm_dense"] + params["mlm_bias"]),
           params["mlm_ln_w"], params["mlm_ln_b"])
    return mean_nll(x @ params["embed"].T, targets, loss_mask)


def run_steps(step, steps: int):
    """``steps`` calls of ``step() -> loss``: the losses, each call's host
    ms (synchronised before, and ending in the loss's read) and each
    call's launches."""
    import torch

    losses, step_ms, counts = [], [], []
    for _ in range(steps):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        counts.append({k: after[k] - before[k] for k in after})
    return losses, step_ms, counts


def check_steps(losses, counts, want) -> None:
    if any(c != want for c in counts):
        raise AssertionError(f"launches per step {counts} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def phase_gpt2_training(dev):
    """GPT-2 345M, 24 layers, batch 8 x 1024: the step-0 gradient check,
    then TRAIN_STEPS train_steps with tree-mode fused_adam."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.models import gpt2
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt2.gpt2_345m()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = gpt2.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ),
                           generator=gen, device="cuda")
    batch = (tokens, torch.roll(tokens, -1, dims=-1))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tree.leaves(params))

    def kernel_loss(t):
        return gpt2.loss_fn(t, batch, cfg, remat=True,
                            vocab_chunks=GPT2_CHUNKS)

    grads = grad_check(params, kernel_loss,
                       lambda t: gpt2_plain_loss(t, batch, cfg))
    torch.cuda.empty_cache()

    tx = fused_adam(lr=GPT2_LR)
    state = {"opt": tx.init(params)}

    def step():
        _, state["opt"], loss = gpt2.train_step(
            params, state["opt"], batch, cfg, tx, remat=True,
            vocab_chunks=GPT2_CHUNKS)
        return loss

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, counts = run_steps(step, TRAIN_STEPS)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    # forward: 2 LayerNorms a layer and the final one; the backward's
    # recompute of each layer runs both LayerNorms and the softmax again
    want = dict({k: 0 for k in total}, layer_norm_fwd=4 * L + 1,
                layer_norm_bwd=2 * L + 1, fused_softmax_causal=2 * L)
    check_steps(losses, counts, want)
    tokens_per_step = GPT2_BATCH * GPT2_SEQ
    flops = step_flops(n_params, L, cfg.hidden_size, GPT2_SEQ, GPT2_BATCH)
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])  # step 1 allocates m, v
    return step, {
            "phase": "gpt2_training", "model": "gpt2_345m", "num_layers": L,
            "dtype": "bfloat16", "batch": GPT2_BATCH, "seq": GPT2_SEQ,
            "params": n_params, "optimizer": "fused_adam(lr=1e-4)",
            "remat": True, "vocab_chunks": GPT2_CHUNKS, "init_s": init_s,
            "grad_check": grads, "losses": losses, "step_ms": step_ms,
            "steady_step_ms": mean_ms,
            "tokens_per_s": tokens_per_step / mean_ms * 1e3,
            "step_flops": flops, "tflops_per_s": flops / mean_ms / 1e9,
            "mfu": flops / (mean_ms * 1e-3) / dev["bf16_flops"],
            "peak_memory_bytes": peak, "launches_per_step": counts[0],
            "launches": total, "expected_per_step": want}


def phase_bert_training(dev):
    """BERT-base, 12 layers, batch 8 x 512 with the 15% masking and a
    padding mask: the step-0 gradient check, then TRAIN_STEPS
    train_steps with fused_lamb."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers import fused_lamb

    cfg = bert.bert_base()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = bert.init_params(gen, cfg, device="cuda")
    shape = (BERT_BATCH, BERT_SEQ)
    tokens = torch.randint(4, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    mlm = torch.rand(shape, generator=gen, device="cuda") < 0.15
    pad = bert_pad_mask(gen, BERT_BATCH, BERT_SEQ)
    inputs = torch.where(mlm, 3, torch.where(pad, 0, tokens))
    batch = (inputs, tokens, (mlm & ~pad).float())
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tree.leaves(params))

    grads = grad_check(
        params, lambda t: bert.loss_fn(t, batch, cfg, pad_mask=pad,
                                       remat=True),
        lambda t: bert_plain_loss(t, batch, cfg, pad))
    torch.cuda.empty_cache()

    tx = fused_lamb(lr=BERT_LR)
    state = {"opt": tx.init(params)}

    def step():
        _, state["opt"], loss = bert.train_step(
            params, state["opt"], batch, cfg, tx, pad_mask=pad, remat=True)
        return loss

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, counts = run_steps(step, TRAIN_STEPS)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    # the embedding's and the MLM head's LayerNorms, 2 a layer, and the
    # recompute of each layer's 2 and its softmax in the backward
    want = dict({k: 0 for k in total}, layer_norm_fwd=4 * L + 2,
                layer_norm_bwd=2 * L + 2, fused_softmax_masked=2 * L)
    check_steps(losses, counts, want)
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])  # step 1 allocates m, v
    return step, {
            "phase": "bert_training", "model": "bert_base", "num_layers": L,
            "dtype": "bfloat16", "batch": BERT_BATCH, "seq": BERT_SEQ,
            "valid_tokens": int((~pad).sum()),
            "masked_tokens": int(batch[2].sum()), "params": n_params,
            "optimizer": "fused_lamb(lr=1e-3)", "remat": True,
            "init_s": init_s, "grad_check": grads, "losses": losses,
            "step_ms": step_ms, "steady_step_ms": mean_ms,
            "sequences_per_s": BERT_BATCH / mean_ms * 1e3,
            "tokens_per_s": BERT_BATCH * BERT_SEQ / mean_ms * 1e3,
            "peak_memory_bytes": peak, "launches_per_step": counts[0],
            "launches": total, "expected_per_step": want}


# the bf16 flash backward's design, named in its two summary rows
FLASH_BWD_DESIGN = {
    "design": "tensor cores",
    "instruction": "wgmma m64nNk16 bf16 -> fp32 for every product: S and "
                   "dP from 128-byte-swizzled shared memory, dQ, dK and "
                   "dV with A (dS, P) from registers and B transposed; "
                   "cp.async tiles"}


def summary(kernels, counts, path_adam):
    """One row per kernel; ``launches`` sums the paths' runs,
    ``launches_by_path`` splits them. ``path_adam`` is the training
    phase's check of its Adam launch on the packed slab."""
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
    lnf, lnb = kernels["layer_norm_fwd"], kernels["layer_norm_bwd"]
    smc = kernels["fused_softmax_causal"]
    smm = kernels["fused_softmax_masked"]
    cast = kernels["fp8_cast"]
    long = kernels["fused_softmax_long"]["causal"]
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
            bwd["max_abs_err"]["dq"], **covers, **FLASH_BWD_DESIGN),
        row("flash_attention_bwd_dkv", csrc + "flash_bwd.cu",
            "apex_tpu/ops/flash_attention.py:322",
            dict(bwd["dkv"], shape=bwd["shape"], **both),
            max(bwd["max_abs_err"]["dk"], bwd["max_abs_err"]["dv"]),
            **covers, **FLASH_BWD_DESIGN),
        row("rms_norm_bwd", csrc + "rms_norm.cu",
            "apex_tpu/ops/layer_norm.py:189", rbwd,
            max(rbwd["max_abs_err"].values())),
        row("fused_adam", csrc + "fused_adam.cu",
            "apex_tpu/ops/fused_adam_kernel.py:35",
            dict(adam, shape=[adam["n"]]), adam["max_abs_err"]["delta"],
            path_max_abs_err=path_adam),
        # LayerNorm at GPT-2's shape (the BERT shape's numbers are in the
        # kernels phase), errors over both
        row("layer_norm_fwd", csrc + "layer_norm.cu",
            "apex_tpu/ops/layer_norm.py:40", lnf[0],
            max(x["max_abs_err"] for x in lnf)),
        row("layer_norm_bwd", csrc + "layer_norm.cu",
            "apex_tpu/ops/layer_norm.py:163", lnb[0],
            max(max(x["max_abs_err"].values()) for x in lnb)),
        row("fused_softmax_causal", csrc + "fused_softmax.cu",
            "apex_tpu/transformer/functional/fused_softmax.py:104", smc,
            smc["max_abs_err"]),
        row("fused_softmax_masked", csrc + "fused_softmax.cu",
            "apex_tpu/transformer/functional/fused_softmax.py:119", smm,
            smm["max_abs_err"]),
        # the casts at their serving shapes: the prefill activation
        # row-major, the weight column-major (the other shapes are in the
        # kernels phase); the long-row passes at the causal shape
        row("fp8_cast", csrc + "fp8_cast.cu",
            "apex_tpu/ops/fp8_cast_kernel.py:31", cast["activation"],
            max(x["max_abs_err"] for x in cast.values())),
        row("fp8_cast_col", csrc + "fp8_cast.cu",
            "apex_tpu/ops/fp8_cast_kernel.py:31", cast["weight"],
            cast["weight"]["max_abs_err"]),
        row("fused_softmax_stats", csrc + "fused_softmax.cu",
            "apex_tpu/transformer/functional/fused_softmax.py:160",
            dict(long["stats"], shape=long["shape"],
                 library_ms=long["library_ms"]),
            long["max_abs_err"]["l"], library_covers="stats+apply"),
        row("fused_softmax_apply", csrc + "fused_softmax.cu",
            "apex_tpu/transformer/functional/fused_softmax.py:195",
            dict(long["apply"], shape=long["shape"],
                 library_ms=long["library_ms"]),
            long["max_abs_err"]["y"], library_covers="stats+apply"),
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
        params, cfg, native_results, serving = phase_serving()
        emit(serving)
        if profiling:
            phase = "profile"
            emit(phase_profile(params, cfg))
        phase = "serving_fp8"
        gc.collect()
        torch.cuda.empty_cache()
        serving_fp8 = phase_serving_fp8(params, cfg, native_results)
        emit(serving_fp8)
        # the profile's timed scheduler methods close over the engine
        # that holds the serving params: a reference cycle, which only
        # the collector frees
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase = "long_context"
        long_context = phase_long_context(dev)
        emit(long_context)
        gc.collect()
        torch.cuda.empty_cache()
        phase = "training"
        reset_counts()
        step, training = phase_training(dev)
        emit(training)
        if profiling:
            phase = "profile_training"
            emit(profile_step(phase, step))
        del step
        results = {}
        for path, run in (("gpt2_training", phase_gpt2_training),
                          ("bert_training", phase_bert_training)):
            phase = path
            gc.collect()
            torch.cuda.empty_cache()
            reset_counts()
            step, results[path] = run(dev)
            emit(results[path])
            if profiling:
                phase = "profile_" + path
                emit(profile_step(phase, step))
            del step
    except Exception as exc:  # report which phase failed, then fail
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"[:2000]})
        return 1
    counts = {"serving": serving["launches"],
              "serving_fp8": serving_fp8["launches"],
              "long_context": {
                  k: sum(long_context[c]["launches"][k] for c in (
                      "causal", "padding", "causal_padding"))
                  for k in serving["launches"]},
              "training": training["launches"],
              **{path: r["launches"] for path, r in results.items()}}
    emit({"kernel_counts": counts})
    emit(summary(kernels, counts, training["adam_path_check"]))
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
