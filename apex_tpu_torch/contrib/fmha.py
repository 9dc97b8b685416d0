"""Fused multi-head attention (port of ``apex_tpu/contrib/fmha.py``; ref
apex/contrib/fmha/fmha.py ``FMHAFun``), over the flash kernels of
:mod:`apex_tpu_torch.ops.flash_attention`.

The reference consumes varlen packed sequences (qkv [total, 3, h, d] +
cu_seqlens). Here, as in the JAX package, batches stay padded-dense
(qkv [b, s, 3, h, d]) and each sequence's length goes to the kernels as
``kv_lens``: keys past it are masked inside the kernels and tiles past it
are skipped; the padded query rows of the output, and so of the
gradient, are zero. Dropout drops the softmax probabilities inside the
kernels with a counter-based keep mask, which the backward kernels
recompute from the seed.

q, k and v are the strided views ``qkv[:, :, i]``: the kernels take any
strides with a contiguous head dim, so nothing is copied.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention


def fmha(q, k, v, causal: bool = False, scale: Optional[float] = None,
         dropout_p: float = 0.0, dropout_key=None,
         deterministic: bool = False):
    """[b, s, h, d] fused attention (k/v may have fewer heads).

    ``dropout_p`` drops softmax probabilities inside the kernels (ref
    fmha.py:35 p_dropout); pass ``dropout_key`` (an int seed in
    [0, 2**32) or a ``torch.Generator``) when training.
    """
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           dropout_p=dropout_p, dropout_key=dropout_key,
                           deterministic=deterministic)


def fmha_packed_qkv(qkv, causal: bool = False,
                    scale: Optional[float] = None, seqlens=None,
                    dropout_p: float = 0.0, dropout_key=None,
                    deterministic: bool = False):
    """qkv [b, s, 3, h, d] (the reference's packed layout, batched).

    ``seqlens`` [b] masks each sequence's padding inside the kernels (the
    reference's varlen cu_seqlens semantics on the padded-dense layout).
    """
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           kv_lens=seqlens, dropout_p=dropout_p,
                           dropout_key=dropout_key,
                           deterministic=deterministic)


class FMHAFun:
    """ref fmha.py ``FMHAFun.apply`` (padded-dense qkv [b, s, 3, h, d]).

    ``cu_seqlens`` (cumulative, [b + 1], the reference's varlen boundary
    vector) or ``seqlens`` ([b]) mask out each sequence's padding.
    """

    @staticmethod
    def apply(qkv, cu_seqlens=None, seqlens=None, p_dropout=0.0,
              max_s=None, is_training=True, zero_tensors=False,
              dropout_key=None):
        """``p_dropout`` drops softmax probabilities in the kernels (ref
        fmha.py:35). Pass a fresh ``dropout_key`` every step (an int seed
        or a ``torch.Generator``, which gives a new seed each call): a
        fixed key repeats the same mask every step."""
        del max_s, zero_tensors
        if qkv.ndim != 5:
            raise ValueError(
                "FMHAFun takes padded-dense qkv [b, s, 3, h, d]; flat "
                "varlen packing is unpacked with cu_seqlens upstream")
        if seqlens is None and cu_seqlens is not None:
            cu = torch.as_tensor(cu_seqlens, device=qkv.device)
            seqlens = cu[1:] - cu[:-1]
        if p_dropout and is_training and dropout_key is None:
            raise ValueError(
                "FMHAFun.apply with p_dropout in training needs "
                "dropout_key (an int seed or a torch.Generator, fresh each "
                "step): a fixed implicit key would repeat the same dropout "
                "mask every step and bias training")
        return fmha_packed_qkv(qkv, seqlens=seqlens, dropout_p=p_dropout,
                               dropout_key=dropout_key,
                               deterministic=not is_training)
