"""Candidate measurement: races on the card, a roofline model off it
(counterpart of ``apex_tpu/tuning/measure.py``).

On the card each candidate runs through the real dispatch path:
:func:`geometry.override <apex_tpu_torch.tuning.geometry.override>` pins
the plan, ``kernel_config.force("on")`` selects the kernel and
``force("off")`` the plain version, and
:func:`apex_tpu_torch.runtime.timing.time_scanned` times them on CUDA
events (each output feeds the next call where the kernel allows it).
:func:`live_runner` builds a sweep's inputs once, from a
``torch.Generator``.

Off the card a deterministic roofline ranks the candidates: no RNG and
no device, so a CPU run is testable and stable. Its constants are the
H100 SXM's (80GB HBM3, 700 W), as PERF.md uses them: 3.35 TB/s of HBM
(every raced kernel is bound by its bytes), a launch's floor of 0.0027 ms (PERF.md's row 4, RMSNorm on 128 x 64) and
0.0039 ms a further wave of blocks (the 0.0066 ms floor of row 1's
smallest fp32 flash call, less the launch). Too few resident threads to
cover the memory latency scale the bandwidth down. Roofline entries are
recorded with ``source='roofline'`` under the device kind ``"cpu"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from apex_tpu_torch.tuning import geometry, search_space

HBM_BW = 3.35e12
LAUNCH_S = 2.7e-6
WAVE_S = 3.9e-6
# threads an SM keeps resident, and the resident threads over the card
# that keep the HBM busy (half of them)
SM_THREADS = 2048
SATURATING_THREADS = search_space.SMS * SM_THREADS // 2


def backend_is_cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def _ceil_div(a, b):
    return -(-a // b)


def _grid_time(nbytes: float, blocks: int, threads: int) -> float:
    """Seconds of one launch of ``blocks`` blocks of ``threads`` moving
    ``nbytes``: the launch, its waves beyond the first, and the bytes at
    the share of the bandwidth its resident threads can draw."""
    resident = max(1, min(32, SM_THREADS // threads))
    per_wave = search_space.SMS * resident
    waves = _ceil_div(blocks, per_wave)
    active = min(blocks, per_wave) * threads
    share = min(1.0, active / SATURATING_THREADS)
    return LAUNCH_S + (waves - 1) * WAVE_S + nbytes / (HBM_BW * share)


def _isz(dims) -> int:
    return search_space.dtype_of(dims).itemsize


# ------------------------------------------------------ roofline models


def _roofline_norm(params, dims):
    rows, h, isz = dims["rows"], dims["h"], _isz(dims)
    threads = params["row_threads"] * params["rows_per_block"]
    nbytes = rows * h * isz * 2 + rows * 4 * 2  # x in, y out, statistics
    return _grid_time(nbytes, params["blocks"], threads)


def _roofline_norm_plain(dims):
    # the fp32 upcast, its square, the mean, the scaling and the cast
    # back: about six fp32 passes over [rows, h], each a launch
    rows, h, isz = dims["rows"], dims["h"], _isz(dims)
    return 6 * LAUNCH_S + rows * h * (2 * isz + 6 * 4) / HBM_BW


def _flat_adam_bytes(n: int) -> int:
    return n * (4 + 2 + 4 + 4 + 2 + 4 + 4)  # g, p, m, v in; delta, m, v


def _roofline_flat_adam(params, dims):
    n = dims["n"]
    threads = params["threads"]
    blocks = min(params["blocks"], search_space._flat_adam_want(n, threads))
    return _grid_time(_flat_adam_bytes(n), blocks, threads)


def _roofline_flat_adam_plain(dims):
    # about fifteen elementwise launches, each an fp32 pass
    n = dims["n"]
    return 15 * LAUNCH_S + (_flat_adam_bytes(n) + 15 * n * 8) / HBM_BW


def _roofline_fp8_cast(params, dims):
    n, isz = dims["n"], _isz(dims)
    threads = params["threads"]
    want = _ceil_div(_ceil_div(n, 16 // isz), threads * 4)
    blocks = max(1, min(want, search_space.SMS * params["blocks_per_sm"],
                        search_space.FP8_AMAX_SLOTS))
    return _grid_time(n * (isz + 1), blocks, threads)


def _roofline_fp8_cast_plain(dims):
    n, isz = dims["n"], _isz(dims)
    return 5 * LAUNCH_S + n * (isz + 4 * 4 + 1) / HBM_BW


def _softmax_rows(dims):
    return dims.get("rows", 1024), dims["sk"]


def _roofline_softmax(params, dims):
    rows, sk = _softmax_rows(dims)
    isz = _isz(dims)
    # two passes, a block a row: the stats pass reads x, the apply pass
    # reads x again and writes y
    return (_grid_time(rows * sk * isz, rows, params["threads"])
            + _grid_time(rows * sk * isz * 2, rows, params["threads"]))


def _roofline_softmax_plain(dims):
    rows, sk = _softmax_rows(dims)
    return 8 * LAUNCH_S + rows * sk * (2 * _isz(dims) + 8 * 4) / HBM_BW


def roofline(kernel, params, dims) -> float:
    """Modelled seconds of the kernel at ``params``."""
    if kernel == "flat_adam":
        return _roofline_flat_adam(params, dims)
    if kernel in ("layer_norm", "rms_norm"):
        return _roofline_norm(params, dims)
    if kernel == "fused_softmax":
        return _roofline_softmax(params, dims)
    if kernel == "fp8_cast":
        return _roofline_fp8_cast(params, dims)
    raise ValueError(f"unknown kernel {kernel!r}")


def roofline_plain(kernel, dims) -> float:
    """Modelled seconds of the plain PyTorch version."""
    if kernel == "flat_adam":
        return _roofline_flat_adam_plain(dims)
    if kernel in ("layer_norm", "rms_norm"):
        return _roofline_norm_plain(dims)
    if kernel == "fused_softmax":
        return _roofline_softmax_plain(dims)
    if kernel == "fp8_cast":
        return _roofline_fp8_cast_plain(dims)
    raise ValueError(f"unknown kernel {kernel!r}")


# ---------------------------------------------------- live measurement


class Runner(NamedTuple):
    """A sweep's inputs and how to run them: ``time_scanned(make_fn,
    carry, chain, k)`` times the path dispatch selects; ``outputs()``
    runs it once on the initial inputs (m and v of the flat Adam on
    copies) and returns its tensors, for a check against the plain
    version."""

    make_fn: Callable
    carry: tuple
    chain: Callable
    k: int
    outputs: Callable


def _keep(carry):
    """A chain whose carry does not change: the call's output is dropped
    (its launches still run in order on the stream)."""
    def chain(c, step):
        step(*c)
        return c
    return chain


def live_runner(kernel, dims, device=None) -> Runner:
    """Build the measurement inputs once for ``kernel`` at ``dims`` on
    ``device`` (default: the current CUDA device) from a generator
    seeded with 0, and reuse them across the sweep."""
    import torch

    from apex_tpu_torch import _device

    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = search_space.dtype_of(dims)

    def randn(*shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    if kernel in ("layer_norm", "rms_norm"):
        from apex_tpu_torch.ops import layer_norm as ln

        rows, h = dims["rows"], dims["h"]
        x = randn(rows, h)
        w = (1 + 0.1 * randn(h, dt=torch.float32)).to(dtype)
        b = 0.1 * randn(h) if kernel == "layer_norm" else None

        def make_fn():
            if b is not None:
                return lambda x: ln.layer_norm(x, w, b, (h,))
            return lambda x: ln.rms_norm(x, w, (h,))

        return Runner(make_fn, (x,), lambda c, step: (step(*c),), 32,
                      lambda: (make_fn()(x),))

    if kernel == "fused_softmax":
        from apex_tpu_torch.transformer.functional import fused_softmax as fs

        rows, sk = dims.get("rows", 1024), dims["sk"]
        sq = dims.get("sq", min(rows, sk))
        x = randn(rows // sq, sq, sk)
        scale = dims.get("scale", 0.125)

        def make_fn():
            return lambda x: fs.scaled_upper_triang_masked_softmax(
                x, None, scale)

        return Runner(make_fn, (x,), _keep(None), 8,
                      lambda: (make_fn()(x),))

    if kernel == "flat_adam":
        from apex_tpu_torch.ops import fused_adam_kernel as fak

        # fused_adam's defaults (no weight decay) at the training lr, at
        # step 10, on bf16 params
        n = dims["n"]
        g = randn(n, dt=torch.float32, scale=1e-3)
        m = randn(n, dt=torch.float32, scale=1e-4)
        v = randn(n, dt=torch.float32, scale=1e-3).square()
        p = randn(n, dt=torch.bfloat16, scale=2e-2)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                  adam_w_mode=True, bias_correction=True)

        def make_fn():
            return lambda g, p, m, v: fak.adam_flat(g, p, m, v, 1e-4, 10,
                                                    **kw)

        def outputs():
            return make_fn()(g, p, m.clone(), v.clone())

        return Runner(make_fn, (g, p, m, v), _keep(None), 8, outputs)

    if kernel == "fp8_cast":
        from apex_tpu_torch.ops import fp8_cast_kernel as fc

        x = randn(dims["n"])

        def make_fn():
            return lambda x: fc.cast_and_scale_stats(
                x, 1.0, torch.float8_e4m3fn, 448.0)

        return Runner(make_fn, (x,), _keep(None), 16,
                      lambda: make_fn()(x))

    raise ValueError(f"unknown kernel {kernel!r}")


def measure_live(kernel, params, dims, runner=None) -> float:
    """Seconds a call of the kernel at ``params`` on the card."""
    from apex_tpu_torch.ops import kernel_config
    from apex_tpu_torch.runtime import timing

    r = runner or live_runner(kernel, dims)
    with geometry.override(kernel, params), kernel_config.force("on"):
        return float(timing.time_scanned(r.make_fn, r.carry, r.chain, k=r.k))


def measure_live_plain(kernel, dims, runner=None) -> float:
    """Seconds a call of the plain version on the card."""
    from apex_tpu_torch.ops import kernel_config
    from apex_tpu_torch.runtime import timing

    r = runner or live_runner(kernel, dims)
    with kernel_config.force("off"):
        return float(timing.time_scanned(r.make_fn, r.carry, r.chain, k=r.k))


def measure(kernel, params, dims, live=None, runner=None) -> float:
    """The kernel's seconds at ``params``: a race on the card, the
    roofline elsewhere."""
    if live is None:
        live = backend_is_cuda()
    if live:
        return measure_live(kernel, params, dims, runner=runner)
    return roofline(kernel, params, dims)


def measure_plain(kernel, dims, live=None, runner=None) -> float:
    """The plain version's seconds under the same live/roofline rule."""
    if live is None:
        live = backend_is_cuda()
    if live:
        return measure_live_plain(kernel, dims, runner=runner)
    return roofline_plain(kernel, dims)
