"""Flat-buffer fused Adam step (port of
``apex_tpu/ops/fused_adam_kernel.py``).

The kernel is ``csrc/fused_adam.cu``, which replaces the TPU kernel
``_adam_kernel`` (``fused_adam_kernel.py:35``): one elementwise Adam or
AdamW pass over a whole per-dtype parameter slab. It is bound by bytes;
the source file says what its design does about that. It updates m and v
in place, where the Pallas kernel returns new buffers: at Llama-3-8B
width a second m/v pair would cost as much memory as the first.

Dispatch is :func:`apex_tpu_torch.ops.kernel_config.use_kernel`
("flat_adam"): CUDA tensors launch the kernel, CPU tensors (or any under
``force("off")``) take :func:`_adam_flat_plain`, the
plain PyTorch version of the same arithmetic, which updates m and v in
place too. There is no fallback from the kernel to the plain version.
The launch plan (threads a block, the most blocks) comes from
:func:`apex_tpu_torch.tuning.geometry.flat_adam_geometry`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from apex_tpu_torch.ops import _build, kernel_config, kernel_nodes
from apex_tpu_torch.tuning import geometry

# launches of the CUDA Adam kernel; only the CUDA wrapper below adds to
# it, once per launch
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_float] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
    if kernel_nodes.traced(g):
        return _adam_flat_node(g, p, m, v, lr_t, step, b1=b1, b2=b2,
                               eps=eps, weight_decay=weight_decay,
                               adam_w_mode=adam_w_mode,
                               bias_correction=bias_correction)
    lr, c1, c2 = adam_scalars(lr_t, step, b1, b2, bias_correction)
    delta = torch.empty_like(p)
    if g.numel() == 0:
        return delta, m, v
    threads, blocks = geometry.flat_adam_geometry(g.numel())
    lib = _lib()
    with torch.cuda.device(g.device):
        rc = lib.adam_flat(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            delta.data_ptr(), g.numel(), lr, c1, c2, b1, 1.0 - b1, b2,
            1.0 - b2, eps, weight_decay, int(bool(adam_w_mode)),
            int(bool(bias_correction)), p_code, threads, blocks,
            _build.stream_handle(g.device))
        _build.check(lib, rc, "adam_flat")
        launches += 1
        # m and v are updated in place, out of autograd's sight: their
        # version counters move as an ATen in-place op's would, and the
        # probe sees g and p as the inputs
        torch.autograd.graph.increment_version(m)
        torch.autograd.graph.increment_version(v)
        kernel_config.note_launch("adam_flat", (g, p), (delta, m, v))
    return delta, m, v


def _adam_flat_node(g, p, m, v, lr_t, step, *, b1, b2, eps, weight_decay,
                    adam_w_mode, bias_correction):
    """The kernel as one node of a traced graph (``kernel_nodes``): the
    launch's plan, the step (and a tensor learning rate) as inputs, since
    a traced value has no number to read, and m and v written back with
    ``copy_`` as the kernel writes them in place."""
    delta = torch.empty_like(p)
    if g.numel() == 0:
        return delta, m, v
    n = g.numel()
    threads, max_blocks = geometry.flat_adam_geometry(n)
    # csrc/fused_adam.cu launch_t: a thread a 4-vector where every slab
    # starts on 4 of its elements (a new allocation does)
    vec = all(t.storage_offset() % 4 == 0 for t in (g, p, m, v))
    work = -(-n // 4) if vec else n
    blocks = max(1, min(-(-work // threads), max_blocks))
    lr_in = lr_t if isinstance(lr_t, torch.Tensor) else None
    lr = 0.0 if lr_in is not None else float(lr_t)
    step_in = step if isinstance(step, torch.Tensor) else None
    delta, m_new, v_new = kernel_nodes.node(
        "adam_flat", (g, p, m, v, step_in, lr_in),
        kernel_nodes.KernelPlan(threads, 0, 0, blocks, 0, n, 4),
        (delta, m, v),
        (lr, 0.0 if step_in is not None else float(step), b1, b2, eps,
         weight_decay, float(bool(adam_w_mode)),
         float(bool(bias_correction))))
    m.copy_(m_new)
    v.copy_(v_new)
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
    if kernel_config.use_kernel("flat_adam", g):
        return _adam_flat_cuda(g, p, m, v, lr_t, step, **kw)
    return _adam_flat_plain(g, p, m, v, lr_t, step, **kw)
