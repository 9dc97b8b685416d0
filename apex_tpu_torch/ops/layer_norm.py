"""Fused RMSNorm forward (port of ``apex_tpu/ops/layer_norm.py``).

The forward kernel is ``csrc/rms_norm.cu``, which replaces the TPU kernel
``_rms_fwd_kernel`` (``apex_tpu/ops/layer_norm.py:56``). It is bound by
bytes: it reads x and w once and writes y and the fp32 ``rstd``. The
source file says how its design follows from that.

Dispatch follows the input tensor: a CUDA tensor launches the kernel, a
CPU tensor takes :func:`_rms_fwd_plain`, the plain PyTorch version of the
same math (``_rms_fwd_jnp``, ``layer_norm.py:337``). There is no fallback
from the kernel to the plain version. The backward kernel and LayerNorm
belong to later slices of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build

# launches of the CUDA RMSNorm-forward kernel; only the CUDA wrapper
# below adds to it, once per launch
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _lib():
    lib = _build.library("rms_norm")
    lib.rms_norm_fwd.argtypes = _ARGTYPES
    lib.rms_norm_fwd.restype = ctypes.c_int
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
    if torch.is_grad_enabled() and (x2.requires_grad or (
            w is not None and w.requires_grad)):
        raise NotImplementedError(
            "rms_norm backward has no CUDA kernel yet; call under "
            "torch.no_grad()")
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


def _rms_fwd(x2, w, eps):
    if x2.is_cuda:
        return _rms_fwd_cuda(x2, w, eps)
    return _rms_fwd_plain(x2, w, eps)


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
    """Fused RMSNorm over trailing ``normalized_shape`` dims."""
    normalized_shape = ((normalized_shape,)
                        if isinstance(normalized_shape, int)
                        else tuple(normalized_shape))
    x2, lead = _to_2d(x, normalized_shape)
    w = weight.reshape(-1) if weight is not None else None
    y, _ = _rms_fwd(x2, w, eps)
    return y.reshape(*lead, *normalized_shape)
