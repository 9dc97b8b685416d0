"""Fused scale + mask + softmax (port of
``apex_tpu/transformer/functional/fused_softmax.py``).

Four kernels of one source, ``apex_tpu_torch/ops/csrc/fused_softmax.cu``:

- ``fused_softmax_causal`` and ``fused_softmax_masked`` replace the
  whole-row TPU kernels ``_causal_kernel`` and ``_masked_kernel``
  (``fused_softmax.py:104`` and ``:119``): one pass over rows of up to
  ``_WHOLE_ROW_MAX_SK`` = 16384 keys, the reference's threshold
  (``_pallas_ok``, ``:88``);
- ``fused_softmax_stats`` and ``fused_softmax_apply`` replace the
  long-row kernels ``_stats_kernel`` and ``_apply_kernel`` (``:160`` and
  ``:195``, driven by ``_pallas_blocked``, ``:208``): rows of more keys
  take two passes, one for the per-row max and sum of exponentials, one
  for the output, each in a causal and a masked variant.

The math is the reference's: x * scale in fp32, -10000 (not -inf) where
masked, then ``exp(s - max) / sum``, the result in x's dtype; the long
rows keep the online (max, sum) with its -inf rule (``:179-186``). The
backward is the closed form ``scale * y * (g - sum(g * y))`` from the
saved output alone, in plain PyTorch (``_softmax_bwd_math``, ``:298``),
which the JAX package also leaves to XLA outside any Pallas kernel.

Dispatch is :func:`apex_tpu_torch.ops.kernel_config.dispatch`
("fused_softmax"): a CUDA tensor launches the kernels; a CPU tensor takes
the kernel path's structure in plain PyTorch, :func:`_causal_plain` or
:func:`_masked_plain` and, for long rows, :func:`_blocked_plain`, which
mirrors ``_pallas_blocked``'s two passes over k-blocks of
``_BLOCKED_BK`` keys; ``force("off")`` takes the whole-row plain
versions on any device, as the reference's jnp path.
``FusedScaleMaskSoftmax``'s ``forward_fused_softmax`` and
``forward_torch_softmax`` choose their path for their own call (the
``mode`` of ``kernel_config.dispatch``), leaving the process-wide mode
as it is.
There is no fallback from a kernel to a plain version. The long-row
passes' threads a block come from
:func:`apex_tpu_torch.tuning.geometry.softmax_threads`.
:class:`FusedScaleMaskSoftmax` is the Megatron entry point over both.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, kernel_config, kernel_nodes
from apex_tpu_torch.tuning import geometry, search_space
from apex_tpu_torch.transformer.enums import AttnMaskType

_MASK_FILL = -10000.0
# rows up to this many keys take the whole-row kernels (the reference's
# threshold of its blocked kernels)
_WHOLE_ROW_MAX_SK = 16384
# keys a block of the plain long-row version covers, from the tuner's
# tables, as the reference routes its default
_BLOCKED_BK = search_space.default_softmax_block_k()

# launches of the CUDA kernels; only the CUDA wrappers below add to them,
# once per launch
causal_launches = 0
masked_launches = 0
stats_launches = 0
apply_launches = 0

# the whole-row kernels end with (dtype, then the plan: vec, row_threads,
# rows_per_block, then the stream)
_PLAN_TAIL = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_CAUSAL_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_float]
                    + _PLAN_TAIL)
_MASKED_ARGTYPES = ([ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_longlong] * 5
                    + [ctypes.c_float] + _PLAN_TAIL)

# The whole-row kernels' launch plan (csrc/fused_softmax.cu): the copies
# of its constants. threads of a block that holds several rows
# (mirrors kRowBlock of csrc/fused_softmax.cu)
_ROW_BLOCK = 256  # apex-lint: disable=hardcoded-tile-size
# most threads of one row (mirrors kMaxRowThreads of csrc/fused_softmax.cu)
_MAX_ROW_THREADS = 512  # apex-lint: disable=hardcoded-tile-size
# fp32 values of a row a thread holds in registers (kMaxValues)
_MAX_VALUES = 32


class RowPlan(NamedTuple):
    """How a whole-row kernel covers rows of sk keys: ``vec`` elements a
    load (16 bytes' worth, or 1 on the scalar path), ``row_threads``
    threads a row (thread t takes the loads t + k * row_threads), and
    ``rows_per_block`` rows a block (slot g of block b takes row b *
    rows_per_block + g)."""

    vec: int
    row_threads: int
    rows_per_block: int


def _softmax_plan(sk: int, dtype: torch.dtype,
                  aligned: bool = True) -> RowPlan:
    """The whole-row kernels' plan for rows of ``sk`` keys of ``dtype``
    (``aligned``: x and y start on 16 bytes): the fewest threads, a power
    of two from one warp, that hold a row ``_MAX_VALUES`` values a
    thread, and as many rows a block as fill ``_ROW_BLOCK`` threads."""
    if not 1 <= sk <= _WHOLE_ROW_MAX_SK:
        raise ValueError(f"a whole-row softmax takes 1 to "
                         f"{_WHOLE_ROW_MAX_SK} keys, got {sk}")
    vec = 16 // dtype.itemsize
    if not aligned or sk % vec:
        vec = 1
    row_threads = 32
    while row_threads * _MAX_VALUES < sk:
        row_threads *= 2
    return RowPlan(vec, row_threads, max(1, _ROW_BLOCK // row_threads))


def _row_plan(x: torch.Tensor, y: torch.Tensor) -> RowPlan:
    return _softmax_plan(x.shape[-1], x.dtype,
                         kernel_nodes.aligned16(x)
                         and kernel_nodes.aligned16(y))


def _rows_kernel_plan(plan: RowPlan, rows: int,
                      sk: int) -> kernel_nodes.KernelPlan:
    """A whole-row kernel's launch (``launch_rows``): ``rows_per_block``
    rows of ``row_threads`` threads a block."""
    return kernel_nodes.KernelPlan(
        plan.row_threads * plan.rows_per_block, plan.row_threads,
        plan.rows_per_block, -(-rows // plan.rows_per_block), 0, sk,
        plan.vec)


def _blocked_kernel_plan(x: torch.Tensor, rows: int,
                         sk: int) -> kernel_nodes.KernelPlan:
    """A long-row pass's launch: a block a row."""
    threads = geometry.softmax_threads(sk)
    return kernel_nodes.KernelPlan(threads, threads, 1, rows, 0, sk,
                                   16 // x.element_size())


# x, mask, m, l (and y for apply), then as the masked kernel, then the
# threads a block
_BLOCKED_TAIL = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_longlong] * 5
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
_STATS_ARGTYPES = [ctypes.c_void_p] * 4 + _BLOCKED_TAIL
_APPLY_ARGTYPES = [ctypes.c_void_p] * 5 + _BLOCKED_TAIL


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


def _filled_block(x, mask, scale: float, causal: bool, k0: int, k1: int):
    """Keys [k0, k1) of x [..., sq, sk] in fp32: scaled, then the fill
    where causal or the mask (broadcast to x) says masked, in the
    reference's order (``_stats_kernel``, ``:174-178``)."""
    sq, sk = x.shape[-2:]
    xb = x[..., k0:k1].float() * scale
    if causal:
        row = torch.arange(sq, device=x.device)[:, None]
        col = torch.arange(k0, k1, device=x.device)[None, :]
        xb = torch.where(col > row + (sk - sq), _MASK_FILL, xb)
    if mask is not None:
        xb = torch.where(mask.expand(x.shape)[..., k0:k1], _MASK_FILL, xb)
    return xb


def _stats_plain(x, mask, scale: float,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stats pass: fp32 (m, l) over x's last dim, online over blocks
    of ``_BLOCKED_BK`` keys, shifting by 0 where the running max is still
    -inf (``_stats_kernel``, ``:179-186``)."""
    sk = x.shape[-1]
    m = torch.full(x.shape[:-1], -torch.inf, device=x.device)
    l = torch.zeros(x.shape[:-1], device=x.device)
    for k0 in range(0, sk, _BLOCKED_BK):
        xb = _filled_block(x, mask, scale, causal, k0,
                           min(k0 + _BLOCKED_BK, sk))
        m_new = torch.maximum(m, torch.amax(xb, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        l = (l * torch.exp(m - m_safe)
             + torch.sum(torch.exp(xb - m_safe[..., None]), dim=-1))
        m = m_new
    return m, l


def _apply_plain(x, mask, scale: float, causal: bool, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """The apply pass: ``exp(s - m) / l`` block by block, in x's dtype
    (``_apply_kernel``, ``:204``)."""
    sk = x.shape[-1]
    y = torch.empty_like(x)
    for k0 in range(0, sk, _BLOCKED_BK):
        k1 = min(k0 + _BLOCKED_BK, sk)
        xb = _filled_block(x, mask, scale, causal, k0, k1)
        y[..., k0:k1] = torch.exp(xb - m[..., None]) / l[..., None]
    return y


def _blocked_plain(x, mask, scale: float, causal: bool) -> torch.Tensor:
    """The long-row version of both kernels, ``_pallas_blocked``'s two
    passes (``:208``); ``mask`` broadcasts to x or is None."""
    m, l = _stats_plain(x, mask, scale, causal)
    return _apply_plain(x, mask, scale, causal, m, l)


def _softmax_bwd_math(scale: float, y: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """dx = scale * y * (g - sum(g * y)) in fp32, in y's dtype."""
    y32 = y.float()
    g32 = g.float()
    inner = torch.sum(g32 * y32, dim=-1, keepdim=True)
    return (scale * y32 * (g32 - inner)).to(y.dtype)


def _lib():
    lib = _build.library("fused_softmax")
    for name, argtypes in (("fused_softmax_causal", _CAUSAL_ARGTYPES),
                           ("fused_softmax_masked", _MASKED_ARGTYPES),
                           ("fused_softmax_stats", _STATS_ARGTYPES),
                           ("fused_softmax_apply", _APPLY_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str):
    """(sq, sk, rows) of a contiguous x [..., sq, sk] the kernels take."""
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous [..., sq, sk] "
                         f"input, got shape {tuple(x.shape)}")
    sq, sk = x.shape[-2:]
    return sq, sk, x.numel() // sk if sk else 0


def _mask_view(x: torch.Tensor, mask: torch.Tensor):
    """(m4, d1): the bool mask viewed as [d0, d1, sq, sk] beside x, read
    through its broadcast strides, never expanded in memory (unless x has
    more than four dims whose mask strides do not merge, when reshape
    copies the same values)."""
    if mask.dtype != torch.bool or mask.device != x.device:
        raise TypeError(f"the mask must be a bool tensor on {x.device}, got "
                        f"{mask.dtype} on {mask.device}")
    sq, sk = x.shape[-2:]
    d1 = x.shape[-3] if x.dim() > 2 else 1
    return mask.expand(x.shape).reshape(-1, d1, sq, sk), d1


def _causal_cuda(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal kernels on a contiguous x [..., sq, sk]: the whole-row
    one, or the two long-row passes above ``_WHOLE_ROW_MAX_SK`` keys;
    same output as :func:`_causal_plain`."""
    global causal_launches
    sq, sk, rows = _check(x, "scaled_upper_triang_masked_softmax")
    if sk > _WHOLE_ROW_MAX_SK:
        return _blocked_cuda(x, None, scale)
    code = _build.dtype_code(x.dtype, "fused softmax")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    if kernel_nodes.traced(x):
        (y,) = kernel_nodes.node(
            "fused_softmax_causal", (x,),
            _rows_kernel_plan(_row_plan(x, y), rows, sk), (y,), (scale,))
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_causal(x.data_ptr(), y.data_ptr(), rows, sq,
                                      sk, float(scale), code,
                                      *_row_plan(x, y),
                                      _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_causal")
        causal_launches += 1
        kernel_config.note_launch("fused_softmax_causal", (x,), (y,))
    return y


def _masked_cuda(x: torch.Tensor, mask: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """The masked kernels on a contiguous x [..., sq, sk] and a boolean
    ``mask`` that broadcasts to it: the whole-row one, or the two
    long-row passes above ``_WHOLE_ROW_MAX_SK`` keys; same output as
    :func:`_masked_plain`."""
    global masked_launches
    sq, sk, rows = _check(x, "scaled_masked_softmax")
    if sk > _WHOLE_ROW_MAX_SK:
        return _blocked_cuda(x, mask, scale)
    code = _build.dtype_code(x.dtype, "fused softmax")
    m4, d1 = _mask_view(x, mask)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    if kernel_nodes.traced(x):
        (y,) = kernel_nodes.node(
            "fused_softmax_masked", (x, m4),
            _rows_kernel_plan(_row_plan(x, y), rows, sk), (y,), (scale,))
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_masked(
            x.data_ptr(), m4.data_ptr(), y.data_ptr(), rows, sq, sk, d1,
            *m4.stride(), float(scale), code, *_row_plan(x, y),
            _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_masked")
        masked_launches += 1
        kernel_config.note_launch("fused_softmax_masked", (x,), (y,))
    return y


def _blocked_args(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """(sq, sk, rows, mask pointer, d1, strides, dtype code) of a long-row
    pass; a None mask is the causal variant."""
    what = ("scaled_upper_triang_masked_softmax" if mask is None
            else "scaled_masked_softmax")
    sq, sk, rows = _check(x, what)
    code = _build.dtype_code(x.dtype, "fused softmax")
    if mask is None:
        return sq, sk, rows, None, None, 1, (0, 0, 0, 0), code
    m4, d1 = _mask_view(x, mask)
    ptr = None if kernel_nodes.traced(m4) else m4.data_ptr()
    return sq, sk, rows, m4, ptr, d1, m4.stride(), code


def _stats_cuda(x: torch.Tensor, mask: Optional[torch.Tensor],
                scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel on a contiguous x: fp32 (m, l) per row, as
    :func:`_stats_plain` (causal when ``mask`` is None)."""
    global stats_launches
    sq, sk, rows, m4, mask_ptr, d1, strides, code = _blocked_args(x, mask)
    m = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    l = torch.empty_like(m)
    if rows == 0:
        return m, l
    if kernel_nodes.traced(x):
        m, l = kernel_nodes.node(
            "fused_softmax_stats", (x, m4),
            _blocked_kernel_plan(x, rows, sk), (m, l), (scale,))
        return m, l
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_stats(
            x.data_ptr(), mask_ptr, m.data_ptr(), l.data_ptr(), rows, sq,
            sk, d1, *strides, float(scale), code, geometry.softmax_threads(sk),
            _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_stats")
        stats_launches += 1
        kernel_config.note_launch("fused_softmax_stats", (x,), (m, l))
    return m, l


def _apply_cuda(x: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
                m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The apply kernel on a contiguous x and its fp32 (m, l): y in x's
    dtype, as :func:`_apply_plain`."""
    global apply_launches
    sq, sk, rows, m4, mask_ptr, d1, strides, code = _blocked_args(x, mask)
    if m.shape != x.shape[:-1] or l.shape != m.shape or \
            m.dtype != torch.float32 or l.dtype != torch.float32 or \
            not (m.is_contiguous() and l.is_contiguous()):
        raise ValueError("m and l must be contiguous fp32 tensors of x's "
                         "leading shape")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    if kernel_nodes.traced(x):
        (y,) = kernel_nodes.node(
            "fused_softmax_apply", (x, m4, m, l),
            _blocked_kernel_plan(x, rows, sk), (y,), (scale,))
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fused_softmax_apply(
            x.data_ptr(), mask_ptr, m.data_ptr(), l.data_ptr(), y.data_ptr(),
            rows, sq, sk, d1, *strides, float(scale), code,
            geometry.softmax_threads(sk), _build.stream_handle(x.device))
        _build.check(lib, rc, "fused_softmax_apply")
        apply_launches += 1
        kernel_config.note_launch("fused_softmax_apply", (x, m, l), (y,))
    return y


def _blocked_cuda(x: torch.Tensor, mask: Optional[torch.Tensor],
                  scale: float) -> torch.Tensor:
    """Both long-row kernels, one launch each; same output as
    :func:`_blocked_plain`."""
    m, l = _stats_cuda(x, mask, scale)
    return _apply_cuda(x, mask, scale, m, l)


def _causal(x, scale, mode=None):
    path = kernel_config.dispatch("fused_softmax", x, mode=mode)
    if path == "kernel":
        return _causal_cuda(x.contiguous(), scale)
    if path == "interpret" and x.shape[-1] > _WHOLE_ROW_MAX_SK:
        return _blocked_plain(x, None, scale, causal=True)
    return _causal_plain(x, scale)


def _masked(x, mask, scale, mode=None):
    path = kernel_config.dispatch("fused_softmax", x, mode=mode)
    if path == "kernel":
        return _masked_cuda(x.contiguous(), mask, scale)
    if path == "interpret" and x.shape[-1] > _WHOLE_ROW_MAX_SK:
        return _blocked_plain(x, mask, scale, causal=False)
    return _masked_plain(x, mask, scale)


class _FusedSoftmax(torch.autograd.Function):
    """Counterpart of the ``custom_vjp``s ``_causal_softmax`` and
    ``_masked_softmax``: ``mask`` None is causal, a boolean mask the
    masked variant; ``mode`` is this call's dispatch mode (None: the
    current one). Saves only the output."""

    @staticmethod
    def forward(ctx, x, mask, scale: float, mode: Optional[str] = None):
        y = (_causal(x, scale, mode) if mask is None
             else _masked(x, mask, scale, mode))
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _softmax_bwd_math(ctx.scale, y, g), None, None, None


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


class FusedScaleMaskSoftmax(torch.nn.Module):
    """The Megatron dispatch module (``fused_softmax.py:351``), without
    parameters. Causal without a mask takes the causal kernels; causal
    with a padding mask combines the two masks for the masked kernels;
    ``mask_func``, when given with a mask, takes the plain softmax of
    ``mask_func(x * scale, mask)``. On the card every row length has a
    kernel, so the fusion flags are kept for parity only."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise ValueError("both fp16 and bf16 flags are set")
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if self.scale is not None and not self.softmax_in_fp32:
            raise ValueError("softmax should be in fp32 when scaled")

    def forward(self, input, mask=None):
        return self._route(input, mask)

    def _route(self, input, mask, mode: Optional[str] = None):
        scale = float(self.scale if self.scale is not None else 1.0)
        if self.attn_mask_type == AttnMaskType.causal:
            b, np_, sq, sk = input.shape
            if mask is None:
                out = _FusedSoftmax.apply(input.reshape(b * np_, sq, sk),
                                          None, scale, mode)
                return out.reshape(b, np_, sq, sk)
            # causal + padding: the triangle always applies; the combined
            # mask keeps the padding mask's broadcast dims
            mask = mask | _causal_mask(sq, sk, input.device)
        if mask is not None and self.mask_func is not None:
            x = self.mask_func(input.float() * scale, mask)
            return _softmax_fp32(x, input.dtype)
        if mask is None:
            return scaled_masked_softmax(input, None, scale)
        return _FusedSoftmax.apply(input, mask, scale, mode)

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """Whether the fused kernels run (``is_kernel_available``): on
        the card they take every row length, so only a CUDA device
        decides."""
        del mask, b, np_, sq, sk
        return torch.cuda.is_available()

    @staticmethod
    def get_batch_per_block(sq, sk, b, np_) -> int:
        """Rows of the (b*np, sq, sk) batch one CUDA thread block handles
        (``get_batch_per_block``): one, in every kernel here."""
        del sq, sk, b, np_
        return 1

    def forward_fused_softmax(self, input, mask=None):
        """Force the fused path (``fused_softmax.py:415``): the kernels
        (this call's dispatch mode "on"), so ``input`` must lie on the
        card (under ``force("interpret")`` the kernel path's plain
        versions, on any device)."""
        mode = "interpret" if kernel_config.mode() == "interpret" else "on"
        if mode == "on" and not input.is_cuda:
            raise RuntimeError("forward_fused_softmax runs the CUDA kernels: "
                               f"the input lies on {input.device}")
        return self._route(input, mask, mode)

    def forward_torch_softmax(self, input, mask=None):
        """The unfused path (``fused_softmax.py:425``): the plain
        whole-row versions on any device (this call's dispatch mode
        "off")."""
        return self._route(input, mask, "off")
