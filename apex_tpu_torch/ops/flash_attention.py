"""Flash attention, forward and backward (port of
``apex_tpu/ops/flash_attention.py``).

Three kernels, each replacing a TPU kernel of the JAX package:

- ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel`` (``:65``): blocked
  online-softmax attention with the causal mask, GQA (query head
  ``g*rep + r`` reads kv head ``g``), fp32 accumulation, and the per-row
  logsumexp ``lse`` that the backward needs;
- ``csrc/flash_bwd.cu`` ``flash_bwd_dq`` replaces ``_bwd_dq_kernel``
  (``:261``) and ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``
  (``:322``): p recomputed from (q, k, lse); dq summed over the keys,
  dk and dv over the queries of the ``rep`` query heads of each kv head.

All three are bound by operations at training lengths; the source files
say what their designs do about that. ``delta = rowsum(dO * O)`` is a
PyTorch op in fp32 before the dq kernel, as the JAX package leaves it to
XLA outside its kernels (``flash_attention.py:406``).

:class:`_Flash` is the ``torch.autograd.Function`` counterpart of the
``custom_vjp`` ``_flash`` (``:487-516``). Dispatch follows the input
tensors: CUDA tensors launch the kernels, CPU tensors take
:func:`_flash_fwd_plain` and :func:`_flash_bwd_plain`, the plain PyTorch
versions of the same arithmetic computed in one block. There is no
fallback from a kernel to a plain version. ``kv_lens`` and dropout run on
the CPU only for now and raise on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build

_NEG_INF = -1e30
MAX_HEAD_DIM = 128

# launches of the CUDA kernels: flash forward, dq and dk/dv. Only the
# CUDA wrappers below add to them, once per launch
launches = 0
dq_launches = 0
dkv_launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# flash_bwd_dq: 7 pointers, 7 ints, 15 strides; flash_bwd_dkv: 8 pointers,
# 7 ints, 18 strides; both then scale, causal, dtype, stream
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                + [ctypes.c_longlong] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 18
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])


def _flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """Plain version of the kernel: q [bh, sq, d], k/v [bh_kv, sk, d] ->
    (o [bh, sq, d] in q's dtype, lse [bh, sq] fp32). Same masks and
    arithmetic as ``_fwd_kernel``: q scaled in fp32 before QK^T, masked
    scores at -1e30 with p exactly 0 there, l clamped at 1e-30."""
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    rep = bh // bh_kv
    qg = q.float().reshape(bh_kv, rep, sq, d) * scale
    s = torch.einsum("grqd,gkd->grqk", qg, k.float())
    k_pos = torch.arange(sk, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                        torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("grqk,gkd->grqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return (o.reshape(bh, sq, d).to(q.dtype),
            lse.reshape(bh, sq).to(torch.float32))


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """Plain version of the two backward kernels: q/o/do [bh, sq, d],
    k/v [bh_kv, sk, d], lse [bh, sq] fp32 -> (dq in q's dtype, dk, dv
    [bh_kv, sk, d] in k's and v's). The arithmetic of ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel`` in one block: s = scale * (q k^T),
    p = exp(s - lse) with masked p exactly 0, dp = do v^T,
    ds = p * (dp - delta) * scale with delta = rowsum(do * o) in fp32;
    dq = ds k, dk = ds^T q and dv = p^T do summed over the ``rep`` query
    heads of each kv head."""
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    rep = bh // bh_kv
    qf = q.float().reshape(bh_kv, rep, sq, d)
    dof = do.float().reshape(bh_kv, rep, sq, d)
    kf, vf = k.float(), v.float()
    delta = torch.sum(dof * o.float().reshape(bh_kv, rep, sq, d), dim=-1,
                      keepdim=True)
    s = scale * torch.einsum("grqd,gkd->grqk", qf, kf)
    p = torch.exp(s - lse.float().reshape(bh_kv, rep, sq, 1))
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        p = torch.where(k_pos[None, :] <= q_pos[:, None], p,
                        torch.zeros_like(p))
    dp = torch.einsum("grqd,gkd->grqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("grqk,gkd->grqd", ds, kf)
    dk = torch.einsum("grqk,grqd->gkd", ds, qf)
    dv = torch.einsum("grqk,grqd->gkd", p, dof)
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _reference_attention(q, k, v, causal: bool, scale: float,
                         kv_lens: Optional[torch.Tensor] = None):
    """Plain softmax attention (``_reference_attention``,
    ``flash_attention.py:218``): q [bh, sq, d], k/v [bh_kv, sk, d], GQA
    by a grouped einsum with no kv copy. ``kv_lens`` [bh] bounds each
    row's keys."""
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    rep = bh // bh_kv
    qg = q.reshape(bh_kv, rep, sq, d).float()
    s = torch.einsum("grqd,gkd->grqk", qg, k.float()) * scale
    neg = torch.full_like(s, _NEG_INF)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, neg)
    if kv_lens is not None:
        ok = (torch.arange(sk, device=q.device)[None, None, None, :]
              < kv_lens.reshape(bh_kv, rep)[:, :, None, None])
        s = torch.where(ok, s, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("grqk,gkd->grqd", p, v.float())
    return o.reshape(bh, sq, d).to(q.dtype)


def _lib():
    lib = _build.library("flash_fwd")
    lib.flash_fwd.argtypes = _ARGTYPES
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.library("flash_bwd")
    lib.flash_bwd_dq.argtypes = _DQ_ARGTYPES
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = _DKV_ARGTYPES
    lib.flash_bwd_dkv.restype = ctypes.c_int
    return lib


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _check_qkv(q, k, v) -> int:
    """Validate [B, S, H, d] q, k, v for the kernels; returns rep."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash kernel takes [B, S, H, d] q, k, v")
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, d_k = k.shape
    if d_k != d or d > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel needs equal head dims <= "
                         f"{MAX_HEAD_DIM}, got q {d} and k {d_k}")
    if (B * H) % (B_kv * H_kv):
        raise ValueError(f"{B * H} query rows are not a multiple of "
                         f"{B_kv * H_kv} kv rows")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous head dim")
    return (B * H) // (B_kv * H_kv)


def _flash_fwd_cuda(q, k, v, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on [B, S, H, d] views (any strides with a contiguous
    last dim): q [B, sq, H, d], k/v [B_kv, sk, H_kv, d] with
    B*H = rep * B_kv*H_kv. Returns (o [B, sq, H, d] in q's dtype,
    lse [B*H, sq] fp32); flat query row b*H + h reads kv row
    (b*H + h) // rep."""
    global launches
    rep = _check_qkv(q, k, v)
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, _ = k.shape
    o = torch.empty((B, sq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    if B * H == 0 or sq == 0:
        return o, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, H, H_kv, rep, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)), _build.dtype_code(
                q.dtype, "flash_fwd"), _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_fwd")
        launches += 1
    return o, lse


def _flash_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B*H, sq] like lse, from
    [B, sq, H, d] o and do (the XLA op between the JAX package's
    forward and backward kernels, ``flash_attention.py:406``)."""
    B, sq, H, _ = o.shape
    return torch.sum(do.float() * o.float(), dim=-1).transpose(
        1, 2).reshape(B * H, sq).contiguous()


def _check_bwd(q, k, v, do, lse, delta) -> int:
    """Validate the backward kernels' inputs; returns rep."""
    rep = _check_qkv(q, k, v)
    B, sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be like q {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(do.shape)} {do.dtype}")
    if do.stride(-1) != 1:
        raise ValueError("flash kernel needs a contiguous head dim")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B * H, sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"[{B * H}, {sq}] tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return rep


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                       scale: float):
    """The dq kernel on the forward's [B, S, H, d] views; lse and delta
    [B*H, sq] fp32. Returns dq [B, sq, H, d] in q's dtype."""
    global dq_launches
    rep = _check_bwd(q, k, v, do, lse, delta)
    B, sq, H, d = q.shape
    _, sk, H_kv, _ = k.shape
    dq = torch.empty((B, sq, H, d), dtype=q.dtype, device=q.device)
    if B * H == 0 or sq == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, H, H_kv,
            rep, sq, sk, d, *_strides(q), *_strides(k), *_strides(v),
            *_strides(do), *_strides(dq), float(scale), int(bool(causal)),
            _build.dtype_code(q.dtype, "flash_bwd"),
            _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_bwd_dq")
        dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                        scale: float):
    """The dk/dv kernel on the forward's [B, S, H, d] views; lse and
    delta [B*H, sq] fp32. Returns (dk, dv) [B_kv, sk, H_kv, d] in k's
    dtype, each summed over the rep query heads of its kv head."""
    global dkv_launches
    rep = _check_bwd(q, k, v, do, lse, delta)
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, _ = k.shape
    dk = torch.empty((B_kv, sk, H_kv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((B_kv, sk, H_kv, d), dtype=v.dtype, device=v.device)
    if B_kv * H_kv == 0 or sk == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B_kv * H_kv, H, H_kv, rep, sq, sk, d, *_strides(q),
            *_strides(k), *_strides(v), *_strides(do), *_strides(dk),
            *_strides(dv), float(scale), int(bool(causal)),
            _build.dtype_code(q.dtype, "flash_bwd"),
            _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_bwd_dkv")
        dkv_launches += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the forward's views: q/o/do [B, sq, H, d],
    k/v [B_kv, sk, H_kv, d], lse [B*H, sq] fp32 -> (dq, dk, dv) in the
    inputs' dtype, with no transposes or repeated K/V. delta is a
    PyTorch op, then dq launches, then dk/dv."""
    if o.shape != q.shape or o.dtype != q.dtype or o.stride(-1) != 1:
        raise ValueError(f"o must be like q {tuple(q.shape)} {q.dtype} "
                         f"with a contiguous head dim")
    delta = _flash_delta(o, do)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _heads_major(t):
    """[b, s, h, d] -> [b*h, s, d]: flat row b*h_count + h, so query head
    g*rep + r lines up with kv head g."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d)


def _seq_major(t, b: int):
    """[b*h, s, d] -> a [b, s, h, d] view: the inverse of _heads_major."""
    bh, s, d = t.shape
    return t.reshape(b, bh // b, s, d).transpose(1, 2)


def _flash_fwd(q, k, v, causal: bool, scale: float):
    """q [B, sq, H, d], k/v [B_kv, sk, H_kv, d] -> (o [B, sq, H, d],
    lse [B*H, sq] fp32): the counterpart of ``_flash_fwd_pallas``. CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale)
    o, lse = _flash_fwd_plain(_heads_major(q), _heads_major(k),
                              _heads_major(v), causal, scale)
    return _seq_major(o, q.shape[0]), lse


def _flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) on the forward's [B, S, H, d] layout: the counterpart
    of ``_flash_bwd_pallas``. CUDA tensors launch dq then dk/dv, CPU
    tensors take the plain version."""
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    dq, dk, dv = _flash_bwd_plain(
        _heads_major(q), _heads_major(k), _heads_major(v), _heads_major(o),
        lse, _heads_major(do), causal, scale)
    return (_seq_major(dq, q.shape[0]), _seq_major(dk, k.shape[0]),
            _seq_major(dv, v.shape[0]))


class _Flash(torch.autograd.Function):
    """Causal or full attention on [b, s, h, d] with the flash kernels
    (counterpart of the ``custom_vjp`` ``_flash``). Forward saves
    (q, k, v, o, lse); backward runs :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, deterministic: bool = False):
    """Fused attention on [b, s, h, d] (k/v may have fewer heads: GQA).

    Returns [b, sq, h, d] in q's dtype, fp32 softmax inside; gradients
    flow through the backward kernels (:class:`_Flash`). ``kv_lens`` [b]
    bounds each sequence's keys (self-attention only) and zeroes the
    padded query rows; it runs on the CPU (through plain autograd) and
    raises on the card until the kernels take it. Dropout raises
    everywhere for now.
    """
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    sk = k.shape[1]
    if kv_lens is not None and sq != sk:
        raise ValueError(
            f"kv_lens implies self-attention (shared per-row length) but "
            f"sq={sq} != sk={sk}")
    scale = scale if scale is not None else 1.0 / d ** 0.5
    if dropout_p and not deterministic:
        raise NotImplementedError(
            "attention dropout is not ported yet (a later slice)")
    if kv_lens is not None and q.is_cuda:
        raise NotImplementedError(
            "kv_lens has no CUDA kernel path yet (a later slice)")
    if kv_lens is None:
        return _Flash.apply(q, k, v, bool(causal), float(scale))
    # heads-major flatten: q head g*rep+r shares kv head g
    qt, kt, vt = _heads_major(q), _heads_major(k), _heads_major(v)
    kv_lens = torch.as_tensor(kv_lens, dtype=torch.int64, device=q.device)
    o = _seq_major(_reference_attention(
        qt, kt, vt, causal, float(scale),
        kv_lens=torch.repeat_interleave(kv_lens, h)), b)
    q_ok = torch.arange(sq, device=q.device)[None, :] < kv_lens[:, None]
    return torch.where(q_ok[:, :, None, None], o, torch.zeros_like(o))
