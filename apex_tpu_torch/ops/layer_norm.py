"""Fused LayerNorm and RMSNorm, forward and backward (port of
``apex_tpu/ops/layer_norm.py``).

Four kernels from one templated source, ``csrc/norm.cuh``, built as two
libraries. ``csrc/layer_norm.cu``: ``layer_norm_fwd`` replaces the TPU
kernel ``_ln_fwd_kernel`` (``apex_tpu/ops/layer_norm.py:40``) and
``layer_norm_bwd`` replaces ``_ln_bwd_kernel`` (``:163``).
``csrc/rms_norm.cu``: ``rms_norm_fwd`` replaces ``_rms_fwd_kernel``
(``:56``) and ``rms_norm_bwd`` replaces ``_rms_bwd_kernel`` (``:189``).
RMSNorm is LayerNorm without the centring, the bias and db: one wrapper
each for the forward and the backward (:func:`_norm_fwd_cuda`,
:func:`_norm_bwd_cuda`) takes the choice as ``centred``.
All four are bound by bytes: a forward reads x and the affine params once
and writes y and the fp32 statistics; a backward reads x, dy, the
statistics and w and writes dx and the param grads. ``norm.cuh`` says
how its design follows from that.

:class:`_LayerNormAffine`, :class:`_LayerNormPlain`,
:class:`_RMSNormAffine` and :class:`_RMSNormPlain` are the
``torch.autograd.Function`` counterparts of the ``custom_vjp`` functions
of ``layer_norm.py:350-435``: a LayerNorm forward saves (x2, w, mu,
rstd), an RMSNorm forward (x2, w, rstd); a backward returns dx in x's
dtype and the param grads in w's dtype, summed in fp32. Dispatch is
:func:`apex_tpu_torch.ops.kernel_config.use_kernel` ("layer_norm",
"rms_norm"): a CUDA tensor launches the kernels, a CPU tensor (or any
tensor under ``force("off")``) takes the plain PyTorch
versions of the same math (:func:`_ln_fwd_plain`, :func:`_ln_bwd_plain`,
:func:`_rms_fwd_plain`, :func:`_rms_bwd_plain`: ``_ln_fwd_jnp``,
``_ln_bwd_jnp``, ``_rms_fwd_jnp`` and ``_rms_bwd_jnp``,
``layer_norm.py:325``, ``:210``, ``:337`` and ``:226``). There is no
fallback from a kernel to a plain version. The launch plans come from
:mod:`apex_tpu_torch.tuning.geometry` (a tuned plan, else
:func:`_fwd_plan` and :func:`_bwd_plan`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, kernel_config, kernel_nodes
from apex_tpu_torch.tuning import geometry

# launches of the CUDA RMSNorm and LayerNorm forward and backward
# kernels; only the CUDA wrappers below add to them, once per launch
launches = 0
bwd_launches = 0
ln_launches = 0
ln_bwd_launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])
_LN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float] + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
_LN_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])

# The launch plans' constants, copies of csrc/norm.cuh's, shared by the
# forward and the backward.
# threads of a block that holds several rows
# (mirrors kRowBlock of csrc/norm.cuh)
ROW_BLOCK = 256  # apex-lint: disable=hardcoded-tile-size
# most threads of one row on the register paths
# (mirrors kMaxRowThreads of csrc/norm.cuh)
MAX_ROW_THREADS = 512  # apex-lint: disable=hardcoded-tile-size
# 16-byte vectors of x (and of dy in the backward) a thread holds in
# registers (kRowVecs): at most 32 values of a 16-bit dtype, 16 of fp32
ROW_VECS = 4
# most blocks of the backward's first pass, and so rows of its fp32 dw
# partials: enough to fill the card's 132 SMs twice, and fixed, so the
# order of the dw sum does not depend on the device
DW_PARTS = 264
# fp32 column sums a backward block may keep in shared memory (227 KB):
# h of dw for RMSNorm, 2h of dw and db for LayerNorm
SMEM_FLOATS = 232448 // 4
# rows whose threads together fall short of this (a decode step's 8 rows,
# a 512-token prefill) take more threads a row, down to a vector a
# thread: 8 x 4096 in bf16 takes 512 threads a row and 512 x 4096 takes
# 256, each faster on an H100 than the fewest threads (128)
FWD_FILL_THREADS = 1 << 17


class FwdPlan(NamedTuple):
    """How the forward kernel covers [rows, h]. On the register path
    (``registers``) ``row_threads`` threads own a row, ``rows_per_block``
    rows share a block, and slot g of block b takes rows b *
    rows_per_block + g + k * blocks * rows_per_block (the plan gives every
    slot one row; the kernel takes fewer blocks too); on the loop path a
    block of ``row_threads`` threads takes one row (``blocks`` = rows)."""

    row_threads: int
    rows_per_block: int
    blocks: int
    registers: bool


def _fwd_plan(rows: int, h: int, dtype: torch.dtype,
              aligned: bool = True) -> FwdPlan:
    """The forward's untuned launch plan for rows of h elements of
    ``dtype``, a function of the shape alone (never of the card). ``aligned``: x, y,
    w and b start on 16 bytes. Rows of whole 16-byte vectors, at most
    ``MAX_ROW_THREADS * ROW_VECS`` of them, take the register
    path on the fewest threads (a power of two, at least a warp) that
    hold a row ``ROW_VECS`` vectors a thread, doubled while the rows
    together have fewer than ``FWD_FILL_THREADS`` threads and a thread
    keeps a vector; any other row the loop path."""
    v = 16 // dtype.itemsize
    nvec = h // v
    if aligned and h % v == 0 and nvec <= MAX_ROW_THREADS * ROW_VECS:
        row_threads = 32
        while row_threads * ROW_VECS < nvec:
            row_threads *= 2
        while (rows * row_threads < FWD_FILL_THREADS
               and 2 * row_threads <= min(nvec, MAX_ROW_THREADS)):
            row_threads *= 2
        per_block = max(1, min(ROW_BLOCK // row_threads, rows))
        return FwdPlan(row_threads, per_block, -(-rows // per_block), True)
    work = nvec if aligned and h % v == 0 else h
    return FwdPlan(min(1024, max(32, -(-work // 32) * 32)), 1, rows, False)


class BwdPlan(NamedTuple):
    """How the backward kernel covers [rows, h]. On the register path
    (``registers``) ``row_threads`` threads own a row, ``rows_per_block``
    rows share a block, and slot g of block b takes rows b *
    rows_per_block + g + k * blocks * rows_per_block; on the loop path a
    block of ``row_threads`` threads takes every blocks-th row. Either
    way ``blocks`` blocks write as many fp32 partial rows of dw (and db)."""

    row_threads: int
    rows_per_block: int
    blocks: int
    registers: bool

    @property
    def partial_rows(self) -> int:
        return self.blocks


def _bwd_plan(rows: int, h: int, dtype: torch.dtype,
              aligned: bool = True) -> BwdPlan:
    """The backward's untuned launch plan for rows of h elements of
    ``dtype``, a function of the shape alone (never of the card). ``aligned``: x, dy,
    dx and w start on 16 bytes. Rows of whole 16-byte vectors, at most
    ``MAX_ROW_THREADS * ROW_VECS`` of them, take the register
    path on the fewest threads (a power of two, at least a warp) that
    hold a row ``ROW_VECS`` vectors a thread; any other row the loop
    path."""
    v = 16 // dtype.itemsize
    nvec = h // v
    if aligned and h % v == 0 and nvec <= MAX_ROW_THREADS * ROW_VECS:
        row_threads = 32
        while row_threads * ROW_VECS < nvec:
            row_threads *= 2
        per_block = max(1, ROW_BLOCK // row_threads)
        return BwdPlan(row_threads, per_block,
                       min(-(-rows // per_block), DW_PARTS), True)
    work = nvec if h % v == 0 else h
    threads = min(1024, max(32, -(-work // 32) * 32))
    return BwdPlan(threads, 1, min(rows, DW_PARTS), False)


def _ln_fwd_plain(x2: torch.Tensor, w: Optional[torch.Tensor],
                  b: Optional[torch.Tensor], eps: float):
    """x2 [rows, h] -> (y in x2's dtype, mu [rows, 1] fp32, rstd [rows, 1]
    fp32): the mean, then the mean of squared centred values."""
    x = x2.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if w is not None:
        y = y * w.float().reshape(1, -1) + b.float().reshape(1, -1)
    return y.to(x2.dtype), mu, rstd


def _ln_bwd_plain(x2: torch.Tensor, w: Optional[torch.Tensor],
                  mu: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor):
    """x2, dy [rows, h], mu and rstd [rows, 1] fp32 -> dx in x2's dtype,
    and (dx, dw, db) with dw and db in w's dtype, summed in fp32, when
    ``w`` is given (the kernel's math, ``_ln_bwd_jnp``)."""
    x = x2.float()
    g = dy.float()
    xhat = (x - mu) * rstd
    gw = g * w.float().reshape(1, -1) if w is not None else g
    m1 = torch.mean(gw, dim=-1, keepdim=True)
    m2 = torch.mean(gw * xhat, dim=-1, keepdim=True)
    dx = (rstd * (gw - m1 - xhat * m2)).to(x2.dtype)
    if w is None:
        return dx
    return (dx, torch.sum(g * xhat, dim=0).to(w.dtype),
            torch.sum(g, dim=0).to(w.dtype))


def _rms_fwd_plain(x2: torch.Tensor, w: Optional[torch.Tensor],
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 [rows, h] -> (y in x2's dtype, rstd [rows, 1] fp32)."""
    x = x2.float()
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    y = x * rstd
    if w is not None:
        y = y * w.float().reshape(1, -1)
    return y.to(x2.dtype), rstd


def _rms_bwd_plain(x2: torch.Tensor, w: Optional[torch.Tensor],
                   rstd: torch.Tensor, dy: torch.Tensor):
    """x2, dy [rows, h], rstd [rows, 1] fp32 -> dx in x2's dtype, and
    dw in w's dtype summed in fp32 when ``w`` is given (the kernel's
    math, ``_rms_bwd_jnp``)."""
    x = x2.float()
    g = dy.float()
    xhat = x * rstd
    gw = g * w.float().reshape(1, -1) if w is not None else g
    m2 = torch.mean(gw * xhat, dim=-1, keepdim=True)
    dx = (rstd * (gw - xhat * m2)).to(x2.dtype)
    if w is None:
        return dx
    return dx, torch.sum(g * xhat, dim=0).to(w.dtype)


def _lib(centred: bool):
    """The LayerNorm (``centred``) or RMSNorm library, with its name and
    its typed forward and backward entry points."""
    name = "layer_norm" if centred else "rms_norm"
    lib = _build.library(name)
    fwd, bwd = getattr(lib, f"{name}_fwd"), getattr(lib, f"{name}_bwd")
    fwd.argtypes, bwd.argtypes = ((_LN_ARGTYPES, _LN_BWD_ARGTYPES) if centred
                                  else (_ARGTYPES, _BWD_ARGTYPES))
    fwd.restype = bwd.restype = ctypes.c_int
    return lib, name, fwd, bwd


def _check_rows(x2: torch.Tensor, what: str) -> Tuple[int, int]:
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous [rows, h] "
                         f"input, got shape {tuple(x2.shape)}")
    return x2.shape


def _check_dy(dy: torch.Tensor, x2: torch.Tensor, what: str) -> None:
    if (dy.shape != x2.shape or dy.dtype != x2.dtype
            or not dy.is_contiguous() or dy.device != x2.device):
        raise ValueError(f"{what} backward needs a contiguous dy like x "
                         f"{tuple(x2.shape)} {x2.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")


def _check_stat(t: torch.Tensor, x2: torch.Tensor, name: str) -> None:
    rows = x2.shape[0]
    if (t.shape != (rows, 1) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != x2.device):
        raise ValueError(f"{name} must be a contiguous fp32 [{rows}, 1] "
                         f"tensor on {x2.device}")


def _param_code(w: torch.Tensor, x2: torch.Tensor, what: str) -> int:
    """The dtype code of an affine param, which must be a contiguous [h]
    tensor on x2's device."""
    h = x2.shape[1]
    if w.device != x2.device or w.shape != (h,) or not w.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [{h}] tensor on "
                         f"{x2.device}")
    return _build.dtype_code(w.dtype, what)


def kernel_plan(plan, h: int, dtype: torch.dtype,
                smem_bytes: int = 0) -> kernel_nodes.KernelPlan:
    """A forward or backward plan (:class:`FwdPlan`, :class:`BwdPlan`) as
    its launch's :class:`~apex_tpu_torch.ops.kernel_nodes.KernelPlan`:
    ``rows_per_block`` rows of ``row_threads`` threads a block on the
    register path, a block of ``row_threads`` threads a row on the loop
    path (``norm.cuh``)."""
    threads = (plan.row_threads * plan.rows_per_block if plan.registers
               else plan.row_threads)
    return kernel_nodes.KernelPlan(threads, plan.row_threads,
                                   plan.rows_per_block, plan.blocks,
                                   smem_bytes, h, 16 // dtype.itemsize)


def _bwd_smem_bytes(plan: BwdPlan, h: int, n_acc: int,
                    affine: bool) -> int:
    """Dynamic shared memory of a backward block (``norm.cuh``): its fp32
    column sums where it joins several row slots' (register path) or
    keeps them (loop path)."""
    if not affine or (plan.registers and plan.rows_per_block == 1):
        return 0
    return n_acc * h * 4


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(centred: bool, bwd: bool) -> None:
    global launches, bwd_launches, ln_launches, ln_bwd_launches
    if centred and bwd:
        ln_bwd_launches += 1
    elif centred:
        ln_launches += 1
    elif bwd:
        bwd_launches += 1
    else:
        launches += 1


def _norm_fwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
                   b: Optional[torch.Tensor], eps: float, centred: bool):
    """The LayerNorm (``centred``: w and b both or neither) or RMSNorm (no
    b) forward kernel on x2 [rows, h] contiguous: (y, mu, rstd), mu None
    for RMSNorm; the outputs of :func:`_ln_fwd_plain` or
    :func:`_rms_fwd_plain`."""
    what = "layer_norm" if centred else "rms_norm"
    rows, h = _check_rows(x2, what)
    x_code = _build.dtype_code(x2.dtype, what)
    w_code = x_code
    if centred and (w is None) != (b is None):
        raise ValueError("layer_norm takes weight and bias both or neither")
    if w is not None:
        w_code = _param_code(w, x2, f"{what} weight")
    if b is not None:
        if b.dtype != w.dtype:
            raise TypeError(f"{what} bias dtype {b.dtype} differs from "
                            f"the weight's {w.dtype}")
        _param_code(b, x2, f"{what} bias")
    y = torch.empty_like(x2)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    mu = torch.empty_like(rstd) if centred else None
    if rows == 0:
        return y, mu, rstd
    params = (w, b) if centred else (w,)
    stats = (mu, rstd) if centred else (rstd,)
    aligned = all(kernel_nodes.aligned16(t)
                  for t in (x2, y, *params) if t is not None)
    plan = geometry.norm_plan(what, rows, h, x2.dtype, aligned)
    if kernel_nodes.traced(x2):
        y, *stats = kernel_nodes.node(
            f"{what}_fwd", (x2, *params), kernel_plan(plan, h, x2.dtype),
            (y, *stats), (eps,))
        return (y, *stats) if centred else (y, None, *stats)
    lib, name, fwd, _ = _lib(centred)
    with torch.cuda.device(x2.device):
        rc = fwd(_ptr(x2), *map(_ptr, params), _ptr(y), *map(_ptr, stats),
                 rows, h, float(eps), plan.row_threads, plan.rows_per_block,
                 plan.blocks, int(plan.registers), x_code, w_code,
                 _build.stream_handle(x2.device))
        _build.check(lib, rc, f"{name}_fwd")
        _count(centred, bwd=False)
        kernel_config.note_launch(f"{name}_fwd", (x2, *params),
                                  (y, *stats))
    return y, mu, rstd


def _norm_bwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
                   mu: Optional[torch.Tensor], rstd: torch.Tensor,
                   dy: torch.Tensor, centred: bool):
    """The LayerNorm (``centred``) or RMSNorm (mu None) backward kernel on
    contiguous x2, dy [rows, h] and the forward's fp32 [rows, 1]
    statistics: dx, or (dx, dw, db) for LayerNorm and (dx, dw) for RMSNorm
    when ``w`` is given; the outputs of :func:`_ln_bwd_plain` or
    :func:`_rms_bwd_plain`."""
    what = "layer_norm" if centred else "rms_norm"
    rows, h = _check_rows(x2, what)
    _check_dy(dy, x2, what)
    stats = (mu, rstd) if centred else (rstd,)
    for name, t in zip(("mu", "rstd") if centred else ("rstd",), stats):
        _check_stat(t, x2, name)
    x_code = _build.dtype_code(x2.dtype, what)
    w_code = x_code
    n_acc = 2 if centred else 1  # fp32 column sums a block keeps: dw (db)
    if w is not None:
        w_code = _param_code(w, x2, f"{what} weight")
        if n_acc * h > SMEM_FLOATS:
            raise ValueError(f"{what} backward keeps {n_acc} x h={h} fp32 "
                             f"column sums in shared memory: at most "
                             f"{SMEM_FLOATS}")
    dx = torch.empty_like(x2)
    grads = (tuple(torch.empty((h,), dtype=w.dtype, device=w.device)
                   for _ in range(n_acc)) if w is not None else ())
    if rows == 0:
        return dx if w is None else (dx, *(g.zero_() for g in grads))
    aligned = all(kernel_nodes.aligned16(t)
                  for t in (x2, dy, dx, w) if t is not None)
    plan = geometry.norm_bwd_plan(what, rows, h, x2.dtype, aligned,
                                  affine=w is not None)
    if kernel_nodes.traced(x2):
        smem = _bwd_smem_bytes(plan, h, n_acc, w is not None)
        dx, *grads = kernel_nodes.node(
            f"{what}_bwd", (x2, dy, *stats, w),
            kernel_plan(plan, h, x2.dtype, smem), (dx, *grads))
        return dx if w is None else (dx, *grads)
    part = (torch.empty((plan.partial_rows, n_acc * h), dtype=torch.float32,
                        device=x2.device) if w is not None else None)
    out_grads = grads if w is not None else (None,) * n_acc
    lib, name, _, bwd = _lib(centred)
    with torch.cuda.device(x2.device):
        rc = bwd(_ptr(x2), _ptr(dy), *map(_ptr, stats), _ptr(w), _ptr(dx),
                 *map(_ptr, out_grads), _ptr(part), rows, h,
                 plan.row_threads, plan.rows_per_block, plan.blocks,
                 int(plan.registers), x_code, w_code,
                 _build.stream_handle(x2.device))
        _build.check(lib, rc, f"{name}_bwd")
        _count(centred, bwd=True)
        kernel_config.note_launch(f"{name}_bwd", (x2, dy, *stats, w),
                                  (dx, *grads))
    return dx if w is None else (dx, *grads)


def _rms_fwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    y, _, rstd = _norm_fwd_cuda(x2, w, None, eps, centred=False)
    return y, rstd


def _rms_bwd_cuda(x2, w, rstd, dy):
    return _norm_bwd_cuda(x2, w, None, rstd, dy, centred=False)


def _ln_fwd_cuda(x2, w, b, eps):
    return _norm_fwd_cuda(x2, w, b, eps, centred=True)


def _ln_bwd_cuda(x2, w, mu, rstd, dy):
    return _norm_bwd_cuda(x2, w, mu, rstd, dy, centred=True)


def _ln_fwd(x2, w, b, eps):
    if kernel_config.use_kernel("layer_norm", x2):
        return _ln_fwd_cuda(x2, w, b, eps)
    return _ln_fwd_plain(x2, w, b, eps)


def _ln_bwd(x2, w, mu, rstd, dy):
    if kernel_config.use_kernel("layer_norm", x2):
        return _ln_bwd_cuda(x2, w, mu, rstd, dy.contiguous())
    return _ln_bwd_plain(x2, w, mu, rstd, dy)


class _LayerNormAffine(torch.autograd.Function):
    """y = layer_norm(x2) * w + b on [rows, h] (counterpart of the
    ``custom_vjp`` ``_layer_norm_affine``)."""

    @staticmethod
    def forward(ctx, x2, w, b, eps: float):
        y, mu, rstd = _ln_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, mu, rstd = ctx.saved_tensors
        dx, dw, db = _ln_bwd(x2, w, mu, rstd, dy)
        return dx, dw, db, None


class _LayerNormPlain(torch.autograd.Function):
    """y = layer_norm(x2) on [rows, h], no affine (counterpart of the
    ``custom_vjp`` ``_layer_norm_plain``)."""

    @staticmethod
    def forward(ctx, x2, eps: float):
        y, mu, rstd = _ln_fwd(x2, None, None, eps)
        ctx.save_for_backward(x2, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, mu, rstd = ctx.saved_tensors
        return _ln_bwd(x2, None, mu, rstd, dy), None


def _rms_fwd(x2, w, eps):
    if kernel_config.use_kernel("rms_norm", x2):
        return _rms_fwd_cuda(x2, w, eps)
    return _rms_fwd_plain(x2, w, eps)


def _rms_bwd(x2, w, rstd, dy):
    if kernel_config.use_kernel("rms_norm", x2):
        return _rms_bwd_cuda(x2, w, rstd, dy.contiguous())
    return _rms_bwd_plain(x2, w, rstd, dy)


class _RMSNormAffine(torch.autograd.Function):
    """y = rms_norm(x2) * w on [rows, h] (counterpart of the
    ``custom_vjp`` ``_rms_norm_affine``)."""

    @staticmethod
    def forward(ctx, x2, w, eps: float):
        y, rstd = _rms_fwd(x2, w, eps)
        ctx.save_for_backward(x2, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, rstd = ctx.saved_tensors
        dx, dw = _rms_bwd(x2, w, rstd, dy)
        return dx, dw, None


class _RMSNormPlain(torch.autograd.Function):
    """y = rms_norm(x2) on [rows, h], no weight (counterpart of the
    ``custom_vjp`` ``_rms_norm_plain``)."""

    @staticmethod
    def forward(ctx, x2, eps: float):
        y, rstd = _rms_fwd(x2, None, eps)
        ctx.save_for_backward(x2, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, rstd = ctx.saved_tensors
        return _rms_bwd(x2, None, rstd, dy), None


def _to_2d(x: torch.Tensor, normalized_shape: Tuple[int, ...]):
    h = 1
    for s in normalized_shape:
        h *= s
    lead = tuple(x.shape[: x.dim() - len(normalized_shape)])
    if tuple(x.shape[x.dim() - len(normalized_shape):]) != normalized_shape:
        raise ValueError(
            f"input trailing dims {tuple(x.shape)} do not match "
            f"normalized_shape {normalized_shape}")
    return x.reshape(-1, h).contiguous(), lead


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             normalized_shape: Union[int, Sequence[int]],
             eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over trailing ``normalized_shape`` dims,
    differentiable in x and ``weight``."""
    normalized_shape = ((normalized_shape,)
                        if isinstance(normalized_shape, int)
                        else tuple(normalized_shape))
    x2, lead = _to_2d(x, normalized_shape)
    if weight is not None:
        y = _RMSNormAffine.apply(x2, weight.reshape(-1), float(eps))
    else:
        y = _RMSNormPlain.apply(x2, float(eps))
    return y.reshape(*lead, *normalized_shape)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor],
               normalized_shape: Union[int, Sequence[int]],
               eps: float = 1e-5) -> torch.Tensor:
    """Fused LayerNorm over trailing ``normalized_shape`` dims,
    differentiable in x, ``weight`` and ``bias`` (``layer_norm.py:452``)."""
    normalized_shape = ((normalized_shape,)
                        if isinstance(normalized_shape, int)
                        else tuple(normalized_shape))
    x2, lead = _to_2d(x, normalized_shape)
    if weight is not None:
        y = _LayerNormAffine.apply(x2, weight.reshape(-1), bias.reshape(-1),
                                   float(eps))
    else:
        y = _LayerNormPlain.apply(x2, float(eps))
    return y.reshape(*lead, *normalized_shape)
