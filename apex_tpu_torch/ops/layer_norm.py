"""Fused RMSNorm, forward and backward (port of
``apex_tpu/ops/layer_norm.py``).

Both kernels are in ``csrc/rms_norm.cu``: ``rms_norm_fwd`` replaces the
TPU kernel ``_rms_fwd_kernel`` (``apex_tpu/ops/layer_norm.py:56``) and
``rms_norm_bwd`` replaces ``_rms_bwd_kernel`` (``:189``). Both are bound
by bytes: the forward reads x and w once and writes y and the fp32
``rstd``; the backward reads x, dy, rstd and w and writes dx and dw. The
source file says how their designs follow from that.

:class:`_RMSNormAffine` and :class:`_RMSNormPlain` are the
``torch.autograd.Function`` counterparts of the ``custom_vjp``
functions ``_rms_norm_affine`` and ``_rms_norm_plain``
(``layer_norm.py:394-435``): forward saves (x2, w, rstd), backward
returns dx in x's dtype and dw in w's dtype, dw summed in fp32.
Dispatch follows the input tensor: a CUDA tensor launches the kernels,
a CPU tensor takes :func:`_rms_fwd_plain` and :func:`_rms_bwd_plain`,
the plain PyTorch versions of the same math (``_rms_fwd_jnp`` and
``_rms_bwd_jnp``, ``layer_norm.py:337`` and ``:226``). There is no
fallback from a kernel to a plain version. LayerNorm belongs to a later
slice of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build

# launches of the CUDA RMSNorm forward and backward kernels; only the
# CUDA wrappers below add to them, once per launch
launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])

# blocks of the backward's first pass, and so rows of its fp32 dw
# partials: enough to fill the card's 132 SMs twice, and fixed, so the
# order of the dw sum does not depend on the device
DW_PARTS = 264
# h floats of dw sums per block must fit in shared memory (227 KB)
MAX_AFFINE_BWD_H = 232448 // 4


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


def _lib():
    lib = _build.library("rms_norm")
    lib.rms_norm_fwd.argtypes = _ARGTYPES
    lib.rms_norm_fwd.restype = ctypes.c_int
    lib.rms_norm_bwd.argtypes = _BWD_ARGTYPES
    lib.rms_norm_bwd.restype = ctypes.c_int
    return lib


def _rms_fwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on x2 [rows, h] contiguous; same outputs as
    :func:`_rms_fwd_plain`."""
    global launches
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"rms_norm kernel needs a contiguous [rows, h] "
                         f"input, got shape {tuple(x2.shape)}")
    rows, h = x2.shape
    x_code = _build.dtype_code(x2.dtype, "rms_norm")
    w_code = x_code
    if w is not None:
        if (w.device != x2.device or w.shape != (h,)
                or not w.is_contiguous()):
            raise ValueError(f"rms_norm weight must be a contiguous [{h}] "
                             f"tensor on {x2.device}")
        w_code = _build.dtype_code(w.dtype, "rms_norm weight")
    y = torch.empty_like(x2)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    if rows == 0:
        return y, rstd
    lib = _lib()
    with torch.cuda.device(x2.device):
        rc = lib.rms_norm_fwd(
            x2.data_ptr(), w.data_ptr() if w is not None else None,
            y.data_ptr(), rstd.data_ptr(), rows, h, float(eps), x_code,
            w_code, _build.stream_handle(x2.device))
        _build.check(lib, rc, "rms_norm_fwd")
        launches += 1
    return y, rstd


def _rms_bwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
                  rstd: torch.Tensor, dy: torch.Tensor):
    """The backward kernel on contiguous x2, dy [rows, h] and rstd
    [rows, 1] fp32; same outputs as :func:`_rms_bwd_plain`."""
    global bwd_launches
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"rms_norm kernel needs a contiguous [rows, h] "
                         f"input, got shape {tuple(x2.shape)}")
    rows, h = x2.shape
    if (dy.shape != x2.shape or dy.dtype != x2.dtype
            or not dy.is_contiguous() or dy.device != x2.device):
        raise ValueError(f"rms_norm backward needs a contiguous dy like x "
                         f"{tuple(x2.shape)} {x2.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if (rstd.shape != (rows, 1) or rstd.dtype != torch.float32
            or not rstd.is_contiguous() or rstd.device != x2.device):
        raise ValueError(f"rstd must be a contiguous fp32 [{rows}, 1] "
                         f"tensor on {x2.device}")
    x_code = _build.dtype_code(x2.dtype, "rms_norm")
    w_code = x_code
    if w is not None:
        if (w.device != x2.device or w.shape != (h,)
                or not w.is_contiguous()):
            raise ValueError(f"rms_norm weight must be a contiguous [{h}] "
                             f"tensor on {x2.device}")
        if h > MAX_AFFINE_BWD_H:
            raise ValueError(f"rms_norm backward keeps h={h} fp32 dw sums "
                             f"in shared memory: at most "
                             f"{MAX_AFFINE_BWD_H}")
        w_code = _build.dtype_code(w.dtype, "rms_norm weight")
    dx = torch.empty_like(x2)
    dw = (torch.empty((h,), dtype=w.dtype, device=w.device)
          if w is not None else None)
    if rows == 0:
        return dx if w is None else (dx, dw.zero_())
    parts = min(rows, DW_PARTS)
    dw_part = (torch.empty((parts, h), dtype=torch.float32,
                           device=x2.device) if w is not None else None)
    lib = _lib()
    with torch.cuda.device(x2.device):
        rc = lib.rms_norm_bwd(
            x2.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
            w.data_ptr() if w is not None else None, dx.data_ptr(),
            dw.data_ptr() if w is not None else None,
            dw_part.data_ptr() if w is not None else None, rows, h, parts,
            x_code, w_code, _build.stream_handle(x2.device))
        _build.check(lib, rc, "rms_norm_bwd")
        bwd_launches += 1
    return dx if w is None else (dx, dw)


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
