"""Flat-buffer fused Adam step (port of
``apex_tpu/ops/fused_adam_kernel.py``).

The kernel is ``csrc/fused_adam.cu``, which replaces the TPU kernel
``_adam_kernel`` (``fused_adam_kernel.py:35``): one elementwise Adam or
AdamW pass over a whole per-dtype parameter slab. It is bound by bytes;
the source file says what its design does about that. It updates m and v
in place, where the Pallas kernel returns new buffers: at Llama-3-8B
width a second m/v pair would cost as much memory as the first.

Dispatch follows the input tensors: CUDA tensors launch the kernel, CPU
tensors take :func:`_adam_flat_plain`, the plain PyTorch version of the
same arithmetic, which updates m and v in place too. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from apex_tpu_torch.ops import _build

# launches of the CUDA Adam kernel; only the CUDA wrapper below adds to
# it, once per launch
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_float] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def adam_scalars(lr_t, step, b1: float, b2: float,
                 bias_correction: bool) -> Tuple[float, float, float]:
    """(lr_t, c1 = 1 - b1**step, c2 = 1 - b2**step), each computed and
    rounded in fp32 as ``_adam_flat_pallas`` computes them
    (``fused_adam_kernel.py:121-126``); c1 = c2 = 1 without bias
    correction."""
    f32 = torch.float32
    lr = float(torch.as_tensor(lr_t, dtype=f32))
    if not bias_correction:
        return lr, 1.0, 1.0
    step = torch.as_tensor(step, dtype=f32)
    c1 = 1.0 - torch.tensor(b1, dtype=f32) ** step
    c2 = 1.0 - torch.tensor(b2, dtype=f32) ** step
    return lr, float(c1), float(c2)


def _check(g, p, m, v):
    n = g.numel()
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"adam_flat takes contiguous 1-D slabs of one "
                             f"length {n}; {name} is {tuple(t.shape)}")
        if t.device != g.device:
            raise ValueError("g, p, m and v must be on one device")
    if any(t.dtype != torch.float32 for t in (g, m, v)):
        raise TypeError(f"g, m and v must be float32, got {g.dtype}, "
                        f"{m.dtype}, {v.dtype}")


def _adam_flat_plain(g, p, m, v, lr_t, step, *, b1, b2, eps, weight_decay,
                     adam_w_mode, bias_correction):
    """Plain version of the kernel: returns (delta in p's dtype, m, v)
    with m and v overwritten by their new values."""
    _check(g, p, m, v)
    lr, c1, c2 = adam_scalars(lr_t, step, b1, b2, bias_correction)
    p32 = p.float()
    if not adam_w_mode and weight_decay:
        g = g + weight_decay * p32
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * torch.square(g)
    if bias_correction:
        m_hat, v_hat = m_new / c1, v_new / c2
    else:
        m_hat, v_hat = m_new, v_new
    update = m_hat / (torch.sqrt(v_hat) + eps)
    if adam_w_mode and weight_decay:
        update = update + weight_decay * p32
    m.copy_(m_new)
    v.copy_(v_new)
    return (-lr * update).to(p.dtype), m, v


def _lib():
    lib = _build.library("fused_adam")
    lib.adam_flat.argtypes = _ARGTYPES
    lib.adam_flat.restype = ctypes.c_int
    return lib


def _adam_flat_cuda(g, p, m, v, lr_t, step, *, b1, b2, eps, weight_decay,
                    adam_w_mode, bias_correction):
    """The kernel on CUDA slabs; same outputs as
    :func:`_adam_flat_plain`, m and v updated in place."""
    global launches
    _check(g, p, m, v)
    p_code = _build.dtype_code(p.dtype, "adam_flat params")
    lr, c1, c2 = adam_scalars(lr_t, step, b1, b2, bias_correction)
    delta = torch.empty_like(p)
    if g.numel() == 0:
        return delta, m, v
    lib = _lib()
    with torch.cuda.device(g.device):
        rc = lib.adam_flat(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            delta.data_ptr(), g.numel(), lr, c1, c2, b1, 1.0 - b1, b2,
            1.0 - b2, eps, weight_decay, int(bool(adam_w_mode)),
            int(bool(bias_correction)), p_code,
            _build.stream_handle(g.device))
        _build.check(lib, rc, "adam_flat")
        launches += 1
    return delta, m, v


def adam_flat(g, p, m, v, lr_t, step, *, b1, b2, eps, weight_decay,
              adam_w_mode, bias_correction):
    """One fused Adam pass over 1-D slabs (counterpart of
    ``adam_flat_pallas``, ``fused_adam_kernel.py:87``).

    ``g``, ``m``, ``v`` fp32, ``p`` any float dtype; ``lr_t`` and
    ``step`` scalars (numbers or 0-dim tensors). Returns
    ``(delta, m, v)``: delta in p's dtype, m and v the same buffers,
    updated in place."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    if g.is_cuda:
        return _adam_flat_cuda(g, p, m, v, lr_t, step, **kw)
    return _adam_flat_plain(g, p, m, v, lr_t, step, **kw)
