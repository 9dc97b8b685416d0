"""Fused scale + mask + softmax (port of
``apex_tpu/transformer/functional/fused_softmax.py``).

Two kernels of one source, ``apex_tpu_torch/ops/csrc/fused_softmax.cu``:
``fused_softmax_causal`` replaces the TPU kernel ``_causal_kernel``
(``fused_softmax.py:104``) and ``fused_softmax_masked`` replaces
``_masked_kernel`` (``:119``). Both are the whole-row kernels: one pass
over rows of up to ``_WHOLE_ROW_MAX_SK`` = 16384 keys, the reference's
threshold (``_pallas_ok``, ``:88``). Longer rows go, in the reference, to
the two blocked long-row kernels (``_stats_kernel`` and
``_apply_kernel``, ``:160`` and ``:195``), which are not ported: a CUDA
tensor with more keys raises ``NotImplementedError`` and a CPU tensor
takes the plain version, which has no length limit.

The math is the reference's: x * scale in fp32, -10000 (not -inf) where
masked, then max, exp and ``e / sum(e)``, the result in x's dtype. The
backward is the closed form ``scale * y * (g - sum(g * y))`` from the
saved output alone, in plain PyTorch (``_softmax_bwd_math``, ``:298``),
which the JAX package also leaves to XLA outside any Pallas kernel.

Dispatch follows the input tensor: a CUDA tensor launches the kernel, a
CPU tensor takes :func:`_causal_plain` or :func:`_masked_plain`. There
is no fallback from a kernel to a plain version. ``FusedScaleMaskSoftmax``
is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch.ops import _build

_MASK_FILL = -10000.0
# rows up to this many keys take the whole-row kernels (the reference's
# threshold of its blocked kernels)
_WHOLE_ROW_MAX_SK = 16384

# launches of the CUDA causal and masked kernels; only the CUDA wrappers
# below add to them, once per launch
causal_launches = 0
masked_launches = 0

_CAUSAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p]
_MASKED_ARGTYPES = ([ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_longlong] * 5
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _softmax_fp32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(x.float(), dim=-1).to(dtype)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """True above the diagonal, offset by sk - sq: the masked keys."""
    q = torch.arange(sq, device=device)[:, None]
    k = torch.arange(sk, device=device)[None, :]
    return k > q + (sk - sq)


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    """The kernels' softmax of fp32 rows: max, exp, ``e / sum(e)``."""
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _causal_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal kernel's math on x [..., sq, sk]."""
    xs = x.float() * scale
    mask = _causal_mask(x.shape[-2], x.shape[-1], x.device)
    return _softmax_rows(torch.where(mask, _MASK_FILL, xs)).to(x.dtype)


def _masked_plain(x: torch.Tensor, mask: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The masked kernel's math; ``mask`` (True = masked) broadcasts to
    x's shape."""
    xs = x.float() * scale
    return _softmax_rows(torch.where(mask.expand(x.shape), _MASK_FILL,
                                     xs)).to(x.dtype)


def _softmax_bwd_math(scale: float, y: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """dx = scale * y * (g - sum(g * y)) in fp32, in y's dtype."""
    y32 = y.float()
    g32 = g.float()
    inner = torch.sum(g32 * y32, dim=-1, keepdim=True)
    return (scale * y32 * (g32 - inner)).to(y.dtype)


def _lib():
    lib = _build.library("fused_softmax")
    lib.fused_softmax_causal.argtypes = _CAUSAL_ARGTYPES
    lib.fused_softmax_causal.restype = ctypes.c_int
    lib.fused_softmax_masked.argtypes = _MASKED_ARGTYPES
    lib.fused_softmax_masked.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str):
    """(sq, sk, rows) of a contiguous x [..., sq, sk] the kernel takes."""
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous [..., sq, sk] "
                         f"input, got shape {tuple(x.shape)}")
    sq, sk = x.shape[-2:]
    if sk > _WHOLE_ROW_MAX_SK:
        raise NotImplementedError(
            f"{what}: sk={sk} > {_WHOLE_ROW_MAX_SK} needs the blocked "
            f"long-row kernels (_stats_kernel and _apply_kernel of "
            f"apex_tpu/transformer/functional/fused_softmax.py), which are "
            f"not ported to CUDA yet")
    return sq, sk, x.numel() // sk if sk else 0


def _causal_cuda(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal kernel on a contiguous x [..., sq, sk]; same output as
    :func:`_causal_plain`."""
    global causal_launches
    sq, sk, rows = _check(x, "scaled_upper_triang_masked_softmax")
    code = _build.dtype_code(x.dtype, "fused softmax")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_causal(x.data_ptr(), y.data_ptr(), rows, sq,
                                      sk, float(scale), code,
                                      _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_causal")
        causal_launches += 1
    return y


def _masked_cuda(x: torch.Tensor, mask: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """The masked kernel on a contiguous x [..., sq, sk] and a boolean
    ``mask`` that broadcasts to it; same output as :func:`_masked_plain`.
    The mask is read through its broadcast strides, never expanded in
    memory (unless x has more than four dims whose mask strides do not
    merge, when reshape copies the same values)."""
    global masked_launches
    sq, sk, rows = _check(x, "scaled_masked_softmax")
    code = _build.dtype_code(x.dtype, "fused softmax")
    if mask.dtype != torch.bool or mask.device != x.device:
        raise TypeError(f"the mask must be a bool tensor on {x.device}, got "
                        f"{mask.dtype} on {mask.device}")
    d1 = x.shape[-3] if x.dim() > 2 else 1
    m4 = mask.expand(x.shape).reshape(-1, d1, sq, sk)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_masked(
            x.data_ptr(), m4.data_ptr(), y.data_ptr(), rows, sq, sk, d1,
            *m4.stride(), float(scale), code, _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_masked")
        masked_launches += 1
    return y


def _causal(x, scale):
    if x.is_cuda:
        return _causal_cuda(x.contiguous(), scale)
    return _causal_plain(x, scale)


def _masked(x, mask, scale):
    if x.is_cuda:
        return _masked_cuda(x.contiguous(), mask, scale)
    return _masked_plain(x, mask, scale)


class _FusedSoftmax(torch.autograd.Function):
    """Counterpart of the ``custom_vjp``s ``_causal_softmax`` and
    ``_masked_softmax``: ``mask`` None is the causal kernel, a boolean
    mask the masked one. Saves only the output."""

    @staticmethod
    def forward(ctx, x, mask, scale: float):
        y = _causal(x, scale) if mask is None else _masked(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _softmax_bwd_math(ctx.scale, y, g), None, None


def scaled_upper_triang_masked_softmax(inputs, _, scale: float = 1.0):
    """Causal scale + softmax on [attn_batches, sq, sk]
    (``fused_softmax.py:335``)."""
    return _FusedSoftmax.apply(inputs, None, float(scale))


def scaled_masked_softmax(inputs, mask, scale: float = 1.0):
    """Mask-fill + scale + softmax on [b, np, sq, sk]; ``mask`` is boolean
    with True = masked and broadcasts to the input
    (``fused_softmax.py:341``). ``mask=None`` is the plain scaled softmax,
    with no kernel, as in the reference."""
    if mask is None:
        return _softmax_fp32(inputs.float() * scale, inputs.dtype)
    return _FusedSoftmax.apply(inputs, mask, float(scale))
