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
dtype and the param grads in w's dtype, summed in fp32. Dispatch follows
the input tensor: a CUDA tensor launches the kernels, a CPU tensor takes
the plain PyTorch versions of the same math (:func:`_ln_fwd_plain`,
:func:`_ln_bwd_plain`, :func:`_rms_fwd_plain`, :func:`_rms_bwd_plain`:
``_ln_fwd_jnp``, ``_ln_bwd_jnp``, ``_rms_fwd_jnp`` and ``_rms_bwd_jnp``,
``layer_norm.py:325``, ``:210``, ``:337`` and ``:226``). There is no
fallback from a kernel to a plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build

# launches of the CUDA RMSNorm and LayerNorm forward and backward
# kernels; only the CUDA wrappers below add to them, once per launch
launches = 0
bwd_launches = 0
ln_launches = 0
ln_bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_LN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
_LN_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])

# blocks of the backward's first pass, and so rows of its fp32 dw
# partials: enough to fill the card's 132 SMs twice, and fixed, so the
# order of the dw sum does not depend on the device
DW_PARTS = 264
# fp32 column sums a backward block may keep in shared memory (227 KB):
# h of dw for RMSNorm, 2h of dw and db for LayerNorm
SMEM_FLOATS = 232448 // 4


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
    lib, name, fwd, _ = _lib(centred)
    with torch.cuda.device(x2.device):
        rc = fwd(_ptr(x2), *map(_ptr, params), _ptr(y), *map(_ptr, stats),
                 rows, h, float(eps), x_code, w_code,
                 _build.stream_handle(x2.device))
        _build.check(lib, rc, f"{name}_fwd")
        _count(centred, bwd=False)
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
    parts = min(rows, DW_PARTS)
    part = (torch.empty((parts, n_acc * h), dtype=torch.float32,
                        device=x2.device) if w is not None else None)
    out_grads = grads if w is not None else (None,) * n_acc
    lib, name, _, bwd = _lib(centred)
    with torch.cuda.device(x2.device):
        rc = bwd(_ptr(x2), _ptr(dy), *map(_ptr, stats), _ptr(w), _ptr(dx),
                 *map(_ptr, out_grads), _ptr(part), rows, h, parts, x_code,
                 w_code, _build.stream_handle(x2.device))
        _build.check(lib, rc, f"{name}_bwd")
        _count(centred, bwd=True)
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
    if x2.is_cuda:
        return _ln_fwd_cuda(x2, w, b, eps)
    return _ln_fwd_plain(x2, w, b, eps)


def _ln_bwd(x2, w, mu, rstd, dy):
    if x2.is_cuda:
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
    if x2.is_cuda:
        return _rms_fwd_cuda(x2, w, eps)
    return _rms_fwd_plain(x2, w, eps)


def _rms_bwd(x2, w, rstd, dy):
    if x2.is_cuda:
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
