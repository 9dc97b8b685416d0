"""Fused fp8 cast-and-scale with the pre-scale amax (port of
``apex_tpu/ops/fp8_cast_kernel.py``).

The kernel is ``csrc/fp8_cast.cu``, which replaces the TPU kernel
``_cast_scale_kernel`` (``fp8_cast_kernel.py:31``): one pass over a
buffer that writes ``sat_cast(clip(x * scale, -fmax, fmax))`` in E4M3 or
E5M2 and ``max(|x|)``. It is bound by bytes; the source file says what
its design does about that and about NaN. Any length is taken as it is:
the TPU's padding to a ``(rows, cols)`` slab has no counterpart, so the
tuner's slab geometry has none either.

``col_major=True`` casts a 2-D ``x`` into a ``y`` laid out column-major
(strides ``(1, rows)``), the layout ``torch._scaled_mm`` takes for its
second operand, with a second kernel of the same source that writes
``y^T`` through shared-memory tiles: the fp8 weight needs no copy into
that layout afterwards.

A cast is one launch: the kernels finish amax themselves (the last block
folds the blocks' maxima), through a scratch buffer of a counter and a
slot a block that the wrapper keeps per device and stream
(:func:`_scratch`): made and zeroed once, and left with its counter at 0
by every launch, so no cast needs a fill kernel first.

Dispatch is :func:`apex_tpu_torch.ops.kernel_config.use_kernel`
("fp8_cast"): a CUDA tensor launches a kernel (a 0-dim one too; an empty
one raises, as ``max`` of nothing does on every device), a CPU tensor
(or any under ``force("off")``) takes
:func:`_cast_and_scale_plain`, the reference's ``_cast_and_scale_jnp``
math (``:80``). There is no fallback from a kernel to the plain version.
The row-major kernel's launch plan (threads a block, blocks an SM) comes
from :func:`apex_tpu_torch.tuning.geometry.fp8_cast_geometry`; the
column-major kernel keeps 256 threads and 8 blocks an SM.
"""

from __future__ import annotations

import ctypes
from numbers import Real
from typing import Dict, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, kernel_config, kernel_nodes
from apex_tpu_torch.tuning import geometry

# launches of the CUDA cast kernels, row-major y and column-major y; only
# the CUDA wrapper below adds to them, once per launch
launches = 0
col_launches = 0
# fill kernels the wrapper launched on a scratch buffer: one when a
# stream's buffer is made, one when a failed launch re-zeroes its counter
fills = 0

# amax slots of a scratch buffer, and so most blocks of a cast (untuned,
# the kernels take at most 8 an SM: 1056 on an H100)
AMAX_SLOTS = 2048
# (device index, stream handle) -> int32 [1 + AMAX_SLOTS]: the blocks'
# counter, then a slot a block
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}

ScaleLike = Union[Real, torch.Tensor]

# fp8 format codes, kept in step with csrc/fp8_cast.cu Fp8Code
FP8_CODES = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]
_ARGTYPES_T = _ARGTYPES[:3] + [ctypes.c_longlong] + _ARGTYPES[3:]

# the column-major kernel's (threads a block, most blocks an SM, rows and
# columns of x a tile), and the row-major one's 16-byte loads a thread
# (kThreadsT, kBlocksPerSmT, kTileR, kTileC and kVecs of csrc/fp8_cast.cu)
_COL_GEOMETRY = (256, 8, 128, 64)
_ROW_VECS = 4
# the row-major entry takes its launch plan before the stream
_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def as_scale(scale: ScaleLike, device) -> torch.Tensor:
    """The scale as a 0-dim fp32 tensor on ``device`` (``jnp.asarray(
    scale, jnp.float32)``)."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"the scale must be one value, got shape "
                             f"{tuple(scale.shape)}")
        return scale.reshape(()).to(device=device, dtype=torch.float32)
    return torch.full((), float(scale), dtype=torch.float32, device=device)


def _check_col_major(x: torch.Tensor, col_major: bool) -> None:
    if col_major and x.dim() != 2:
        raise ValueError(f"a column-major cast takes a 2-D x, got shape "
                         f"{tuple(x.shape)}")


def _cast_and_scale_plain(x: torch.Tensor, scale: ScaleLike,
                          dtype: torch.dtype, fmax: float,
                          col_major: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels: ``(y in dtype, amax)``. ``clamp``
    and ``amax`` propagate NaN, as the reference's ``clip`` and ``max``
    do."""
    _check_col_major(x, col_major)
    x32 = x.float()
    amax = torch.amax(torch.abs(x32))
    s = as_scale(scale, x.device)
    y = torch.clamp(x32 * s, -fmax, fmax).to(dtype)
    return (y.t().contiguous().t() if col_major else y), amax


def _lib():
    lib = _build.library("fp8_cast")
    lib.fp8_cast_scale.argtypes = _ARGTYPES
    lib.fp8_cast_scale.restype = ctypes.c_int
    lib.fp8_cast_scale_t.argtypes = _ARGTYPES_T
    lib.fp8_cast_scale_t.restype = ctypes.c_int
    return lib


def _scratch(device: torch.device) -> torch.Tensor:
    """The scratch buffer of ``device``'s current stream, made and zeroed
    on the stream's first cast. Each stream has its own, so casts on two
    streams at once never share a counter; on one stream the launches run
    in turn, each leaving the counter at 0."""
    global fills
    key = (device.index, _build.stream_handle(device))
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = torch.zeros(1 + AMAX_SLOTS, dtype=torch.int32, device=device)
        fills += 1
        _SCRATCH[key] = buf
    return buf


def cast_plan(x: torch.Tensor, col_major: bool) -> kernel_nodes.KernelPlan:
    """The launch plan of a cast of contiguous ``x`` (``csrc/fp8_cast.cu``
    ``launch`` and ``launch_t``): blocks up to the work's, at most the
    amax slots and the blocks an SM times the card's SMs."""
    sms = kernel_nodes.sm_count(x.device)
    vec = 16 // x.element_size()
    if col_major:
        threads, per_sm, tile_r, tile_c = _COL_GEOMETRY
        rows, cols = x.shape
        want = -(-rows // tile_r) * -(-cols // tile_c)
        return kernel_nodes.KernelPlan(
            threads, 0, 0, min(want, AMAX_SLOTS, per_sm * sms), 0, cols,
            vec)
    n = x.numel()
    threads, per_sm = geometry.fp8_cast_geometry(n)
    work = n // vec + n % vec if kernel_nodes.aligned16(x) else n
    want = -(-work // (threads * _ROW_VECS))
    return kernel_nodes.KernelPlan(
        threads, 0, 0, max(1, min(want, AMAX_SLOTS, per_sm * sms)), 0, n,
        vec)


def _cast_and_scale_cuda(x: torch.Tensor, scale: ScaleLike,
                         dtype: torch.dtype, fmax: float,
                         col_major: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A kernel on a CUDA tensor of any shape (2-D with ``col_major``);
    same outputs as :func:`_cast_and_scale_plain`, y bit for bit. A
    tensor scale is read on the card (no host sync); a number is passed
    by value."""
    global launches, col_launches, fills
    _check_col_major(x, col_major)
    code = _build.dtype_code(x.dtype, "fp8 cast")
    fp8 = FP8_CODES.get(dtype)
    if fp8 is None:
        raise TypeError(f"fp8 cast: the target dtype must be one of "
                        f"{sorted(map(str, FP8_CODES))}, got {dtype}")
    if x.numel() == 0:
        raise RuntimeError("fp8 cast: max(|x|) of an empty tensor has no "
                           "value")
    x = x.contiguous()
    amax = torch.empty((), dtype=torch.float32, device=x.device)
    s = (as_scale(scale, x.device) if isinstance(scale, torch.Tensor)
         else None)
    if kernel_nodes.traced(x):
        y = (torch.empty((x.shape[1], x.shape[0]), dtype=dtype,
                         device=x.device).t() if col_major
             else torch.empty(x.shape, dtype=dtype, device=x.device))
        y, amax = kernel_nodes.node(
            "fp8_cast_scale_t" if col_major else "fp8_cast_scale", (x, s),
            cast_plan(x, col_major), (y, amax),
            (0.0 if s is not None else float(scale), fmax, fp8))
        return y, amax
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = _scratch(x.device)
        tail = (None if s is None else s.data_ptr(),
                0.0 if s is not None else float(scale), float(fmax),
                amax.data_ptr(), scratch.data_ptr(), AMAX_SLOTS)
        stream = _build.stream_handle(x.device)
        if col_major:
            rows, cols = x.shape
            y = torch.empty((cols, rows), dtype=dtype, device=x.device).t()
            what = "fp8_cast_scale_t"
            rc = lib.fp8_cast_scale_t(x.data_ptr(), y.data_ptr(), rows, cols,
                                      code, fp8, *tail, stream)
        else:
            y = torch.empty(x.shape, dtype=dtype, device=x.device)
            what = "fp8_cast_scale"
            rc = lib.fp8_cast_scale(x.data_ptr(), y.data_ptr(), x.numel(),
                                    code, fp8, *tail,
                                    *geometry.fp8_cast_geometry(x.numel()),
                                    stream)
        if rc != 0:
            # a launch that failed part-way may have counted blocks in
            scratch[0].zero_()
            fills += 1
        _build.check(lib, rc, what)
        if col_major:
            col_launches += 1
        else:
            launches += 1
        kernel_config.note_launch(what, (x,), (y, amax))
    return y, amax


def cast_and_scale_stats(x: torch.Tensor, scale: ScaleLike,
                         dtype: torch.dtype, fmax: float, *,
                         col_major: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sat_cast(x * scale) -> dtype, max(|x|))`` in one fused pass
    (``cast_and_scale_stats``, ``fp8_cast_kernel.py:88``). ``fmax`` is
    the target format's largest magnitude: an fp8 overflow clamps to it,
    never rounds to inf or NaN. ``col_major`` lays a 2-D y out
    column-major; its values are the same."""
    if kernel_config.use_kernel("fp8_cast", x):
        return _cast_and_scale_cuda(x, scale, dtype, fmax, col_major)
    return _cast_and_scale_plain(x, scale, dtype, fmax, col_major)
