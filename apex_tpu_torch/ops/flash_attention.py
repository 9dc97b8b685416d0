"""Flash-attention forward (port of ``apex_tpu/ops/flash_attention.py``).

The kernel is ``csrc/flash_fwd.cu``, which replaces the TPU kernel
``_fwd_kernel`` (``apex_tpu/ops/flash_attention.py:65``): blocked
online-softmax attention with the causal mask, GQA (query head
``g*rep + r`` reads kv head ``g``), fp32 accumulation, and the per-row
logsumexp ``lse`` that the backward and ring attention will need. It is
bound by operations at prefill lengths; the source file says what its
design does about that.

Dispatch follows the input tensors: CUDA tensors launch the kernel, CPU
tensors take :func:`_flash_fwd_plain`, the plain PyTorch version of the
same masked online softmax computed in one block. There is no fallback
from the kernel to the plain version. The backward kernels, ``kv_lens``
on the card and dropout belong to the training slice of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build

_NEG_INF = -1e30
MAX_HEAD_DIM = 128

# launches of the CUDA flash-forward kernel; only the CUDA wrapper below
# adds to it, once per launch
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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


def _flash_fwd_cuda(q, k, v, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on [B, S, H, d] views (any strides with a contiguous
    last dim): q [B, sq, H, d], k/v [B_kv, sk, H_kv, d] with
    B*H = rep * B_kv*H_kv. Returns (o [B, sq, H, d] in q's dtype,
    lse [B*H, sq] fp32); flat query row b*H + h reads kv row
    (b*H + h) // rep."""
    global launches
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward has no CUDA kernel yet; call under "
            "torch.no_grad()")
    rep = (B * H) // (B_kv * H_kv)
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


def _flash_fwd(q, k, v, causal: bool, scale: float):
    """q [bh, sq, d], k/v [bh_kv, sk, d] -> (o, lse [bh, sq]): the
    counterpart of ``_flash_fwd_pallas``."""
    if q.is_cuda:
        o, lse = _flash_fwd_cuda(q[:, :, None], k[:, :, None],
                                 v[:, :, None], causal, scale)
        return o[:, :, 0], lse
    return _flash_fwd_plain(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, deterministic: bool = False):
    """Fused attention on [b, s, h, d] (k/v may have fewer heads: GQA).

    Returns [b, sq, h, d] in q's dtype, fp32 softmax inside. ``kv_lens``
    [b] bounds each sequence's keys (self-attention only) and zeroes the
    padded query rows; it runs on the CPU and raises on the card until the
    kernel takes it. Dropout raises everywhere for now.
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
            "attention dropout is not ported yet (training slice)")
    if kv_lens is not None and q.is_cuda:
        raise NotImplementedError(
            "kv_lens has no CUDA kernel path yet (training slice)")
    if q.is_cuda:
        o, _ = _flash_fwd_cuda(q, k, v, causal, float(scale))
        return o
    # heads-major flatten: q head g*rep+r shares kv head g
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * h_kv, sk, d)
    vt = v.transpose(1, 2).reshape(b * h_kv, sk, d)
    if kv_lens is None:
        o, _ = _flash_fwd_plain(qt, kt, vt, causal, float(scale))
        return o.reshape(b, h, sq, d).transpose(1, 2)
    kv_lens = torch.as_tensor(kv_lens, dtype=torch.int64, device=q.device)
    o = _reference_attention(qt, kt, vt, causal, float(scale),
                             kv_lens=torch.repeat_interleave(kv_lens, h))
    o = o.reshape(b, h, sq, d).transpose(1, 2)
    q_ok = torch.arange(sq, device=q.device)[None, :] < kv_lens[:, None]
    return torch.where(q_ok[:, :, None, None], o, torch.zeros_like(o))
