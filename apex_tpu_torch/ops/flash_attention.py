"""Flash attention, forward and backward (port of
``apex_tpu/ops/flash_attention.py``).

Three kernels, each replacing a TPU kernel of the JAX package:

- ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel`` (``:65``): blocked
  online-softmax attention with the causal mask, GQA (query head
  ``g*rep + r`` reads kv head ``g``), fp32 accumulation, and the per-row
  logsumexp ``lse`` that the backward needs; bf16 on tensor cores, fp32
  on FMAs;
- ``csrc/flash_bwd.cu`` ``flash_bwd_dq`` replaces ``_bwd_dq_kernel``
  (``:261``) and ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``
  (``:322``): p recomputed from (q, k, lse); dq summed over the keys,
  dk and dv over the queries of the ``rep`` query heads of each kv head.

All three take the JAX kernels' two further branches: ``kv_lens`` (varlen:
keys past each flat query row's length are masked, tiles past it skipped)
and dropout on the softmax probabilities, whose keep mask
(:func:`_keep_mask`, ``csrc/flash_tc.cuh`` ``keep_mask``) is a hash of the
seed and the absolute (row, query, key) coordinates, so the backward
recomputes it and nothing is stored. All three are bound by operations at
training lengths; the source files say what their designs do about that.
``delta = rowsum(dO * O)`` is a PyTorch op in fp32 before the dq kernel,
as the JAX package leaves it to XLA outside its kernels
(``flash_attention.py:406``).

:class:`_Flash` is the ``torch.autograd.Function`` counterpart of the
``custom_vjp`` ``_flash``, ``_flash_dropout`` and ``_flash_varlen``
(``:487-603``). Dispatch is :func:`apex_tpu_torch.ops.kernel_config.
use_kernel` ("flash_attention"): CUDA tensors launch the kernels, CPU
tensors (or any under ``force("off")``) take
:func:`_flash_fwd_plain` and :func:`_flash_bwd_plain`, the plain PyTorch
versions of the same arithmetic computed in one block. There is no
fallback from a kernel to a plain version. The tiles are the ones
compiled into the kernels: (64, 64) in bf16, (64, 32) in fp32.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, kernel_config, kernel_nodes

_NEG_INF = -1e30
MAX_HEAD_DIM = 128

# launches of the CUDA kernels: flash forward, dq and dk/dv. Only the
# CUDA wrappers below add to them, once per launch
launches = 0
dq_launches = 0
dkv_launches = 0

# every entry ends with scale, causal, kv_lens (pointer or None), seed,
# p_drop (double, so that the keep threshold is the one Python computes),
# dtype, stream
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
         ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
# flash_fwd: 5 pointers, 7 ints, 12 strides
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 12 + _TAIL
# flash_bwd_dq: 7 pointers, 7 ints, 15 strides; flash_bwd_dkv: 8 pointers,
# 7 ints, 18 strides
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 15 + _TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 18 + _TAIL

_U32 = 0xFFFFFFFF

# (threads a block, query rows or keys a block) of the kernels by dtype,
# as csrc/flash_fwd.cu, flash_bwd.cu and flash_tc.cuh compile them: bf16
# runs one warpgroup on 64-row tiles, fp32 256 threads on 64-row tiles
_FLASH_GEOMETRY = {torch.bfloat16: (128, 64), torch.float32: (256, 64)}


def _padded_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim a kernel instance is compiled for: 64 or 128 in bf16
    (a swizzled tile is 64 columns), 32, 64 or 128 in fp32."""
    for pad in ((64, 128) if dtype == torch.bfloat16 else (32, 64, 128)):
        if d <= pad:
            return pad
    raise ValueError(f"flash kernel needs a head dim <= {MAX_HEAD_DIM}")


def _smem_bytes(entry: str, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block of ``entry`` (``flash_fwd``,
    ``flash_bwd_dq``, ``flash_bwd_dkv``): ``fwd_smem_bytes``,
    ``dq_smem_bytes`` and ``dkv_smem_bytes`` of the bf16 kernels,
    ``smem_floats``, ``dq_smem_floats`` and ``dkv_smem_floats`` of the
    fp32 ones."""
    D = _padded_dim(d, dtype)
    if dtype == torch.bfloat16:
        tile = 64 * D * 2
        return {"flash_fwd": 5 * tile + 1024,
                "flash_bwd_dq": 6 * tile + 1024,
                "flash_bwd_dkv": 6 * tile + 4 * 64 * 4 + 1024}[entry]
    floats = {"flash_fwd": 64 * (D + 4) + D * 36 + 32 * (D + 4) + 64 * 36,
              "flash_bwd_dq": (2 * 64 * (D + 4) + 2 * D * 36
                               + 32 * (D + 4) + 64 * 36),
              "flash_bwd_dkv": (2 * 64 * (D + 4) + 2 * D * 36
                                + 2 * 32 * (D + 4) + 2 * 64 * 36 + 2 * 32)}
    return floats[entry] * 4


def flash_plan(entry: str, q: torch.Tensor,
               k: torch.Tensor) -> kernel_nodes.KernelPlan:
    """The launch plan of ``entry`` on [B, sq, H, d] q and [B_kv, sk,
    H_kv, d] k: a block a (flat row, 64-row tile) pair of the queries
    (forward, dq) or of the keys (dk/dv)."""
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, _ = k.shape
    threads, tile = _FLASH_GEOMETRY[q.dtype]
    if entry == "flash_bwd_dkv":
        blocks = B_kv * H_kv * -(-sk // tile)
    else:
        blocks = B * H * -(-sq // tile)
    return kernel_nodes.KernelPlan(threads, 0, tile, blocks,
                                   _smem_bytes(entry, d, q.dtype), d,
                                   16 // q.dtype.itemsize)


def _keep_mask(seed, bh, q_pos, k_pos, p_drop: float):
    """Dropout's keep mask (``_keep_mask``, ``flash_attention.py:37``), bit
    for bit: the murmur3 finaliser of ``k_pos * 0x9E3779B9 + q_pos *
    0x85EBCA6B + bh * 0xC2B2AE35 + seed`` in uint32, kept where its top 31
    bits exceed ``min(int(p_drop * 2**31), 2**31 - 1)``. ``bh`` is the
    flat query row ``b*H + h``. The arguments broadcast (ints or integer
    tensors); the arithmetic is int64, masked to 32 bits after every
    product and sum (the low 32 bits survive a signed wrap)."""
    dev = next((a.device for a in (seed, bh, q_pos, k_pos)
                if isinstance(a, torch.Tensor)), None)

    def u32(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev) & _U32

    x = (u32(k_pos) * 0x9E3779B9) & _U32
    x = (x + ((u32(q_pos) * 0x85EBCA6B) & _U32)) & _U32
    x = (x + ((u32(bh) * 0xC2B2AE35) & _U32)) & _U32
    x = (x + u32(seed)) & _U32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    x = x ^ (x >> 16)
    return (x >> 1) > min(int(p_drop * 2147483648.0), 2147483647)


def _drop_masks(bh, sq, sk, rep, seed, p_drop, device):
    """[bh_kv, rep, sq, sk] keep mask of the flat query rows g*rep + r."""
    rows = torch.arange(bh, device=device).reshape(bh // rep, rep, 1, 1)
    return _keep_mask(seed, rows,
                      torch.arange(sq, device=device)[:, None],
                      torch.arange(sk, device=device)[None, :], p_drop)


def _dropped(x, keep, p_drop: float):
    """Inverted dropout with a given keep mask: keep ? x / (1 - p) : 0."""
    return torch.where(keep, x / (1.0 - p_drop), torch.zeros_like(x))


def _key_ok(kv_lens, rep, sk, device):
    """[bh_kv, rep, 1, sk]: key k_pos is below its query row's kv_len."""
    lens = kv_lens.to(device=device, dtype=torch.int64)
    return (torch.arange(sk, device=device)[None, None, None, :]
            < lens.reshape(-1, rep)[:, :, None, None])


def _flash_fwd_plain(q, k, v, causal: bool, scale: float, kv_lens=None,
                     p_drop: float = 0.0, seed: int = 0):
    """Plain version of the kernel: q [bh, sq, d], k/v [bh_kv, sk, d] ->
    (o [bh, sq, d] in q's dtype, lse [bh, sq] fp32). Same masks and
    arithmetic as ``_fwd_kernel``: q scaled in fp32 before QK^T, masked
    scores (causal, keys at or past ``kv_lens`` [bh]) at -1e30 with p
    exactly 0 there, l summing the raw p and clamped at 1e-30, and with
    ``p_drop`` the numerator taking keep ? p / (1 - p_drop) : 0."""
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
    if kv_lens is not None:
        s = torch.where(_key_ok(kv_lens, rep, sk, q.device), s,
                        torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    if p_drop:
        p = _dropped(p, _drop_masks(bh, sq, sk, rep, seed, p_drop,
                                    q.device), p_drop)
    o = torch.einsum("grqk,gkd->grqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return (o.reshape(bh, sq, d).to(q.dtype),
            lse.reshape(bh, sq).to(torch.float32))


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float,
                     kv_lens=None, p_drop: float = 0.0, seed: int = 0):
    """Plain version of the two backward kernels: q/o/do [bh, sq, d],
    k/v [bh_kv, sk, d], lse [bh, sq] fp32 -> (dq in q's dtype, dk, dv
    [bh_kv, sk, d] in k's and v's). The arithmetic of ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel`` in one block: s = scale * (q k^T),
    p = exp(s - lse) with masked p (causal, keys at or past ``kv_lens``)
    selected to exactly 0, dp = do v^T, with ``p_drop`` dp and the p of
    dv taking keep ? x / (1 - p_drop) : 0, ds = p * (dp - delta) * scale
    with delta = rowsum(do * o) in fp32; dq = ds k, dk = ds^T q and
    dv = p^T do summed over the ``rep`` query heads of each kv head."""
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
    if kv_lens is not None:
        p = torch.where(_key_ok(kv_lens, rep, sk, q.device), p,
                        torch.zeros_like(p))
    dp = torch.einsum("grqd,gkd->grqk", dof, vf)
    pm = p
    if p_drop:
        keep = _drop_masks(bh, sq, sk, rep, seed, p_drop, q.device)
        pm, dp = _dropped(p, keep, p_drop), _dropped(dp, keep, p_drop)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("grqk,gkd->grqd", ds, kf)
    dk = torch.einsum("grqk,grqd->gkd", ds, qf)
    dv = torch.einsum("grqk,grqd->gkd", pm, dof)
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _reference_attention(q, k, v, causal: bool, scale: float,
                         kv_lens: Optional[torch.Tensor] = None,
                         p_drop: float = 0.0, seed: int = 0):
    """Plain softmax attention (``_reference_attention``,
    ``flash_attention.py:218``): q [bh, sq, d], k/v [bh_kv, sk, d], GQA
    by a grouped einsum with no kv copy. ``kv_lens`` [bh] bounds each
    row's keys; ``p_drop`` drops probabilities with the kernels' keep
    mask."""
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
        s = torch.where(_key_ok(kv_lens, rep, sk, q.device), s, neg)
    p = torch.softmax(s, dim=-1)
    if p_drop:
        p = _dropped(p, _drop_masks(bh, sq, sk, rep, seed, p_drop,
                                    q.device), p_drop)
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


def _extras(kv_lens, p_drop: float, seed: int, bh: int, device):
    """The kernels' varlen and dropout arguments: (kv_lens pointer or
    None, seed, p_drop). kv_lens must be a contiguous int32 [bh] tensor
    on the inputs' device (one length a flat query row)."""
    if kv_lens is not None and (
            kv_lens.shape != (bh,) or kv_lens.dtype != torch.int32
            or not kv_lens.is_contiguous() or kv_lens.device != device):
        raise ValueError(f"kv_lens must be a contiguous int32 [{bh}] tensor "
                         f"on {device}, got {kv_lens.dtype} "
                         f"{tuple(kv_lens.shape)} on {kv_lens.device}")
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got "
                         f"{p_drop}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"dropout seed must be in [0, 2**32), got {seed}")
    ptr = (kv_lens.data_ptr() if kv_lens is not None
           and not kernel_nodes.traced(kv_lens) else None)
    return ptr, int(seed), float(p_drop)


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, kv_lens=None,
                    p_drop: float = 0.0,
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on [B, S, H, d] views (any strides with a contiguous
    last dim): q [B, sq, H, d], k/v [B_kv, sk, H_kv, d] with
    B*H = rep * B_kv*H_kv. Returns (o [B, sq, H, d] in q's dtype,
    lse [B*H, sq] fp32); flat query row b*H + h reads kv row
    (b*H + h) // rep. ``kv_lens`` int32 [B*H] bounds each flat query
    row's keys; ``p_drop`` > 0 drops probabilities with the keep mask of
    ``seed``."""
    global launches
    rep = _check_qkv(q, k, v)
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, _ = k.shape
    extras = _extras(kv_lens, p_drop, seed, B * H, q.device)
    o = torch.empty((B, sq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    if B * H == 0 or sq == 0:
        return o, lse
    if kernel_nodes.traced(q):
        o, lse = kernel_nodes.node(
            "flash_fwd", (q, k, v, kv_lens), flash_plan("flash_fwd", q, k),
            (o, lse), (scale, float(bool(causal)), p_drop, seed))
        return o, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, H, H_kv, rep, sq, sk, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            float(scale), int(bool(causal)), *extras,
            _build.dtype_code(q.dtype, "flash_fwd"),
            _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_fwd")
        launches += 1
        kernel_config.note_launch("flash_fwd", (q, k, v), (o, lse))
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
                       scale: float, kv_lens=None, p_drop: float = 0.0,
                       seed: int = 0):
    """The dq kernel on the forward's [B, S, H, d] views; lse and delta
    [B*H, sq] fp32; kv_lens, p_drop and seed as the forward took them.
    Returns dq [B, sq, H, d] in q's dtype."""
    global dq_launches
    rep = _check_bwd(q, k, v, do, lse, delta)
    B, sq, H, d = q.shape
    _, sk, H_kv, _ = k.shape
    extras = _extras(kv_lens, p_drop, seed, B * H, q.device)
    dq = torch.empty((B, sq, H, d), dtype=q.dtype, device=q.device)
    if B * H == 0 or sq == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    if kernel_nodes.traced(q):
        (dq,) = kernel_nodes.node(
            "flash_bwd_dq", (q, k, v, do, lse, delta, kv_lens),
            flash_plan("flash_bwd_dq", q, k), (dq,),
            (scale, float(bool(causal)), p_drop, seed))
        return dq
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, H, H_kv,
            rep, sq, sk, d, *_strides(q), *_strides(k), *_strides(v),
            *_strides(do), *_strides(dq), float(scale), int(bool(causal)),
            *extras, _build.dtype_code(q.dtype, "flash_bwd"),
            _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_bwd_dq")
        dq_launches += 1
        kernel_config.note_launch("flash_bwd_dq", (q, k, v, do, lse, delta),
                                  (dq,))
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                        scale: float, kv_lens=None, p_drop: float = 0.0,
                        seed: int = 0):
    """The dk/dv kernel on the forward's [B, S, H, d] views; lse and
    delta [B*H, sq] fp32; kv_lens, p_drop and seed as the forward took
    them. Returns (dk, dv) [B_kv, sk, H_kv, d] in k's dtype, each summed
    over the rep query heads of its kv head."""
    global dkv_launches
    rep = _check_bwd(q, k, v, do, lse, delta)
    B, sq, H, d = q.shape
    B_kv, sk, H_kv, _ = k.shape
    extras = _extras(kv_lens, p_drop, seed, B * H, q.device)
    dk = torch.empty((B_kv, sk, H_kv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((B_kv, sk, H_kv, d), dtype=v.dtype, device=v.device)
    if B_kv * H_kv == 0 or sk == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    if kernel_nodes.traced(q):
        dk, dv = kernel_nodes.node(
            "flash_bwd_dkv", (q, k, v, do, lse, delta, kv_lens),
            flash_plan("flash_bwd_dkv", q, k), (dk, dv),
            (scale, float(bool(causal)), p_drop, seed))
        return dk, dv
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B_kv * H_kv, H, H_kv, rep, sq, sk, d, *_strides(q),
            *_strides(k), *_strides(v), *_strides(do), *_strides(dk),
            *_strides(dv), float(scale), int(bool(causal)), *extras,
            _build.dtype_code(q.dtype, "flash_bwd"),
            _build.stream_handle(q.device))
        _build.check(lib, rc, "flash_bwd_dkv")
        dkv_launches += 1
        kernel_config.note_launch("flash_bwd_dkv",
                                  (q, k, v, do, lse, delta), (dk, dv))
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, scale: float,
                    kv_lens=None, p_drop: float = 0.0, seed: int = 0):
    """The backward on the forward's views: q/o/do [B, sq, H, d],
    k/v [B_kv, sk, H_kv, d], lse [B*H, sq] fp32 -> (dq, dk, dv) in the
    inputs' dtype, with no transposes or repeated K/V. delta is a
    PyTorch op, then dq launches, then dk/dv."""
    if o.shape != q.shape or o.dtype != q.dtype or o.stride(-1) != 1:
        raise ValueError(f"o must be like q {tuple(q.shape)} {q.dtype} "
                         f"with a contiguous head dim")
    delta = _flash_delta(o, do)
    extra = (kv_lens, p_drop, seed)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale, *extra)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                 *extra)
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


def _flash_fwd(q, k, v, causal: bool, scale: float, kv_lens=None,
               p_drop: float = 0.0, seed: int = 0):
    """q [B, sq, H, d], k/v [B_kv, sk, H_kv, d] -> (o [B, sq, H, d],
    lse [B*H, sq] fp32): the counterpart of ``_flash_fwd_pallas``, with
    ``kv_lens`` an int32 [B*H] tensor on q's device or None. The kernel
    or the plain version, as ``kernel_config.use_kernel`` decides."""
    if kernel_config.use_kernel("flash_attention", q):
        return _flash_fwd_cuda(q, k, v, causal, scale, kv_lens, p_drop,
                               seed)
    o, lse = _flash_fwd_plain(_heads_major(q), _heads_major(k),
                              _heads_major(v), causal, scale, kv_lens,
                              p_drop, seed)
    return _seq_major(o, q.shape[0]), lse


def _flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
               kv_lens=None, p_drop: float = 0.0, seed: int = 0):
    """(dq, dk, dv) on the forward's [B, S, H, d] layout: the counterpart
    of ``_flash_bwd_pallas``. The kernels (dq then dk/dv) or the plain
    version, as ``kernel_config.use_kernel`` decides."""
    if kernel_config.use_kernel("flash_attention", q):
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, kv_lens,
                               p_drop, seed)
    dq, dk, dv = _flash_bwd_plain(
        _heads_major(q), _heads_major(k), _heads_major(v), _heads_major(o),
        lse, _heads_major(do), causal, scale, kv_lens, p_drop, seed)
    return (_seq_major(dq, q.shape[0]), _seq_major(dk, k.shape[0]),
            _seq_major(dv, v.shape[0]))


class _Flash(torch.autograd.Function):
    """Causal or full attention on [b, s, h, d] with the flash kernels
    (counterpart of the ``custom_vjp`` ``_flash``, ``_flash_dropout`` and
    ``_flash_varlen``). Forward saves (q, k, v, o, lse, kv_lens) and the
    seed; the backward recomputes the keep mask from the seed (nothing of
    it is stored) in :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, kv_lens=None,
                p_drop: float = 0.0, seed: int = 0):
        o, lse = _flash_fwd(q, k, v, causal, scale, kv_lens, p_drop, seed)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.causal, ctx.scale = causal, scale
        ctx.p_drop, ctx.seed = p_drop, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                                kv_lens, ctx.p_drop, ctx.seed)
        return dq, dk, dv, None, None, None, None, None


def _dropout_seed(dropout_key) -> int:
    """The kernels' uint32 seed from ``dropout_key``: an int in
    [0, 2**32) as it is (the counterpart of JAX's ``_dropout_seed(key)``,
    ``flash_attention.py:610``), or one int drawn from a
    ``torch.Generator`` (a CUDA generator costs a device sync)."""
    if isinstance(dropout_key, torch.Generator):
        return int(torch.randint(0, 2 ** 32, (), generator=dropout_key,
                                 device=dropout_key.device))
    if isinstance(dropout_key, bool) or not isinstance(dropout_key,
                                                       numbers.Integral):
        raise TypeError(f"dropout_key must be an int seed or a "
                        f"torch.Generator, got {type(dropout_key).__name__}")
    if not 0 <= dropout_key < 2 ** 32:
        raise ValueError(f"dropout_key must be in [0, 2**32), got "
                         f"{dropout_key}")
    return int(dropout_key)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, dropout_key=None,
                    deterministic: bool = False):
    """Fused attention on [b, s, h, d] (k/v may have fewer heads: GQA).

    Returns [b, sq, h, d] in q's dtype, fp32 softmax inside; gradients
    flow through the backward kernels (:class:`_Flash`). ``kv_lens`` [b]
    bounds each sequence's keys (self-attention only) and zeroes the
    padded query rows of the output (and so of their gradients).

    ``dropout_p`` drops softmax probabilities inside the kernels
    (inverted dropout, ref apex/contrib/fmha/fmha.py:35): it needs
    ``dropout_key``, an int seed in [0, 2**32) or a ``torch.Generator``
    that one is drawn from per call, unless ``deterministic`` is set, in
    which case dropout is a no-op (eval mode). The same seed gives the
    same mask as the JAX package's kernels with ``_dropout_seed(key)``
    equal to it.
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
    p_drop = 0.0 if deterministic else float(dropout_p)
    if p_drop and dropout_key is None:
        raise ValueError(
            "dropout_p > 0 in training needs dropout_key (an int seed or "
            "a torch.Generator); pass deterministic=True for eval")
    seed = _dropout_seed(dropout_key) if p_drop else 0
    if kv_lens is None:
        return _Flash.apply(q, k, v, bool(causal), float(scale), None,
                            p_drop, seed)
    kv_lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32)
    # one length a flat query row b*h + head, as the kernels index it
    rows = torch.repeat_interleave(kv_lens, h)
    o = _Flash.apply(q, k, v, bool(causal), float(scale), rows, p_drop,
                     seed)
    q_ok = torch.arange(sq, device=q.device)[None, :] < kv_lens[:, None]
    return torch.where(q_ok[:, :, None, None], o, torch.zeros_like(o))
