"""Multi-head attention modules (port of
``apex_tpu/contrib/multihead_attn.py``; ref apex/contrib/multihead_attn/
{self,encdec}_multihead_attn.py and the ``*_norm_add`` variants).

``torch.nn.Module``s over the reference's packed-projection layout, with
the flax module's parameter names and ``kernel [in, out]`` layout, so a
flax param tree loads with :func:`load_flax_params` and no reshape.
Unmasked attention runs the flash kernels (dropout inside them, the keep
mask of JAX's kernels for the same seed); masked attention runs the
padding-masked softmax kernel (``scaled_masked_softmax``) with inverted
dropout drawn from a ``torch.Generator``; the norm-add variants run the
LayerNorm kernels.

Dropout takes ``dropout_key``: an int seed in [0, 2**32) or a
``torch.Generator``, as :mod:`apex_tpu_torch.contrib.fmha` does. The
masked path's keep mask comes from torch's generator, so it is not the
reference's ``jax.random.bernoulli`` mask bit for bit, only in law.
"""

from __future__ import annotations

import numbers
from typing import Dict, Optional

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
)
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.functional.fused_softmax import (
    scaled_masked_softmax,
)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn",
           "mask_softmax_dropout", "MaskSoftmaxDropout", "load_flax_params"]


def _generator(dropout_key, device) -> torch.Generator:
    """``dropout_key`` as a generator on ``device``: a Generator on
    ``device`` as it is, one elsewhere as a new one seeded from it
    (``_device.generator_on``), an int seed as a new one seeded with
    it."""
    if isinstance(dropout_key, torch.Generator):
        return _device.generator_on(dropout_key, device)
    if isinstance(dropout_key, bool) or not isinstance(dropout_key,
                                                       numbers.Integral):
        raise TypeError(f"dropout_key must be an int seed or a "
                        f"torch.Generator, got {type(dropout_key).__name__}")
    return torch.Generator(device=device).manual_seed(int(dropout_key))


def _inverted_dropout(probs, p: float, dropout_key):
    """Zero each element with probability ``p`` and scale the kept ones
    by 1/(1-p) (``multihead_attn.py:24``)."""
    gen = _generator(dropout_key, probs.device)
    u = torch.rand(probs.shape, generator=gen, device=probs.device)
    keep = u < 1.0 - p
    return torch.where(keep, probs / (1.0 - p), torch.zeros_like(probs))


def _masked_attention(q, k, v, key_padding_mask, attn_mask, scale: float,
                      dropout_p: float = 0.0, dropout_key=None):
    """[b, s, h, d] attention with torch-style masks
    (``multihead_attn.py:29``):

    - ``key_padding_mask`` [b, sk], True (nonzero) = pad: padded keys
      leave every query's softmax;
    - ``attn_mask`` [sq, sk], bool or int (nonzero = masked) or additive
      float (-inf = masked), for every batch and head;
    - ``dropout_p``/``dropout_key``: inverted dropout on the softmax
      probabilities.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    b, _, sq, sk = scores.shape
    mask = None
    if key_padding_mask is not None:
        mask = (key_padding_mask != 0)[:, None, None, :].expand(b, 1, sq, sk)
    if attn_mask is not None:
        if not attn_mask.is_floating_point():
            # torch-style byte/int mask (nonzero = masked) or bool
            am = (attn_mask != 0)[None, None].expand(b, 1, sq, sk)
            mask = am if mask is None else mask | am
        else:  # additive float mask: folded into the (scaled) scores
            scores = scores + attn_mask[None, None] / scale
    probs = scaled_masked_softmax(scores, mask, scale).to(v.dtype)
    if dropout_p > 0.0:
        probs = _inverted_dropout(probs, dropout_p, dropout_key)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class _Dense(torch.nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, optional ``bias [out]``,
    the product in the promotion of the input's and the params' dtypes.
    Init: lecun-normal (flax's law), zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 device, dtype):
        super().__init__()
        self.kernel = torch.nn.Parameter(
            torch.empty(in_features, out_features, device=device,
                        dtype=dtype))
        std = in_features ** -0.5 / 0.87962566103423978
        torch.nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std,
                                    b=2 * std)
        self.bias = (torch.nn.Parameter(torch.zeros(out_features,
                                                    device=device,
                                                    dtype=dtype))
                     if bias else None)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y + self.bias.to(dt) if self.bias is not None else y


def _dropout_of(module, is_training: bool, deterministic: Optional[bool]):
    """(p, deterministic) of a call: the reference's ``det`` rule."""
    det = (not is_training) if deterministic is None else deterministic
    return (0.0 if det else module.dropout), det


class _NormAdd(torch.nn.Module):
    """The ``include_norm_add`` params and LayerNorm (``lyr_nrm_*``)."""

    def _init_norm(self, h: int, device, dtype):
        self.lyr_nrm_gamma_weights = torch.nn.Parameter(
            torch.ones(h, device=device, dtype=dtype))
        self.lyr_nrm_beta_weights = torch.nn.Parameter(
            torch.zeros(h, device=device, dtype=dtype))

    def _norm(self, x):
        return fused_layer_norm_affine(x, self.lyr_nrm_gamma_weights,
                                       self.lyr_nrm_beta_weights,
                                       (x.shape[-1],))


class SelfMultiheadAttn(_NormAdd):
    """``multihead_attn.py:64`` (ref self_multihead_attn.py:27,
    impl='fast').

    Input ``[s, b, h]`` (torch MHA layout). ``include_norm_add`` puts a
    LayerNorm before the projections and adds the input back after them
    (ref self_multihead_attn_norm_add). Params live on ``device``
    (default: the GPU, raising when there is none) in ``dtype``.
    """

    def __init__(self, hidden_dim: int, heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False,
                 device: _device.DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = _device.resolve(device)
        self.hidden_dim, self.heads, self.dropout = hidden_dim, heads, dropout
        self.include_norm_add = include_norm_add
        self.separate_qkv_params = separate_qkv_params
        h = hidden_dim
        if include_norm_add:
            self._init_norm(h, device, dtype)
        if separate_qkv_params:
            self.q_proj = _Dense(h, h, bias, device, dtype)
            self.k_proj = _Dense(h, h, bias, device, dtype)
            self.v_proj = _Dense(h, h, bias, device, dtype)
        else:
            self.qkv_proj = _Dense(h, 3 * h, bias, device, dtype)
        self.out_proj = _Dense(h, h, bias, device, dtype)

    def forward(self, query, key_padding_mask=None, attn_mask=None,
                is_training: bool = True,
                deterministic: Optional[bool] = None, dropout_key=None):
        """``dropout_key`` (an int seed or a ``torch.Generator``) is
        needed when dropout applies (training, ``dropout`` > 0)."""
        s, b, h = query.shape
        d = h // self.heads
        x = self._norm(query) if self.include_norm_add else query
        if self.separate_qkv_params:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        else:
            q, k, v = torch.chunk(self.qkv_proj(x), 3, dim=-1)

        def heads_first(t):  # [s, b, h] -> a [b, s, heads, d] view
            return t.transpose(0, 1).unflatten(-1, (self.heads, d))

        # dropout applies to the softmax probs (ref
        # self_multihead_attn_func.py:100), not the output projection
        drop, det = _dropout_of(self, is_training, deterministic)
        if drop > 0.0 and dropout_key is None:
            raise ValueError("dropout in training needs dropout_key (an int "
                             "seed or a torch.Generator)")
        if key_padding_mask is not None or attn_mask is not None:
            o = _masked_attention(heads_first(q), heads_first(k),
                                  heads_first(v), key_padding_mask,
                                  attn_mask, d ** -0.5, dropout_p=drop,
                                  dropout_key=dropout_key)
        else:
            o = flash_attention(heads_first(q), heads_first(k),
                                heads_first(v), causal=False,
                                scale=d ** -0.5, dropout_p=drop,
                                dropout_key=dropout_key, deterministic=det)
        o = self.out_proj(o.reshape(b, s, h).transpose(0, 1))
        if self.include_norm_add:
            o = o + query  # the fused residual add
        return o


class EncdecMultiheadAttn(_NormAdd):
    """``multihead_attn.py:121`` (ref encdec_multihead_attn.py): q from
    the decoder's ``query`` [sq, b, h], k and v from the encoder's
    ``key`` [sk, b, h]; the flash kernels, non-causal, sq may differ
    from sk."""

    def __init__(self, hidden_dim: int, heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 device: _device.DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = _device.resolve(device)
        self.hidden_dim, self.heads, self.dropout = hidden_dim, heads, dropout
        self.include_norm_add = include_norm_add
        h = hidden_dim
        if include_norm_add:
            self._init_norm(h, device, dtype)
        self.q_proj = _Dense(h, h, bias, device, dtype)
        self.kv_proj = _Dense(h, 2 * h, bias, device, dtype)
        self.out_proj = _Dense(h, h, bias, device, dtype)

    def forward(self, query, key, is_training: bool = True,
                deterministic: Optional[bool] = None, dropout_key=None):
        sq, b, h = query.shape
        d = h // self.heads
        x = self._norm(query) if self.include_norm_add else query
        q = self.q_proj(x)
        k, v = torch.chunk(self.kv_proj(key), 2, dim=-1)

        def heads_first(t):
            return t.transpose(0, 1).unflatten(-1, (self.heads, d))

        drop, det = _dropout_of(self, is_training, deterministic)
        o = flash_attention(heads_first(q), heads_first(k), heads_first(v),
                            causal=False, scale=d ** -0.5, dropout_p=drop,
                            dropout_key=dropout_key, deterministic=det)
        o = self.out_proj(o.reshape(b, sq, h).transpose(0, 1))
        if self.include_norm_add:
            o = o + query
        return o


def mask_softmax_dropout(inputs, pad_mask=None, *, heads: int,
                         mask_additive: bool = False,
                         dropout_prob: float = 0.0,
                         is_training: bool = True, dropout_key=None):
    """Mask, softmax and dropout on attention scores
    (``multihead_attn.py:161``; ref mask_softmax_dropout_func.py).

    ``inputs``: scores ``[b*heads, sq, sk]``. ``pad_mask``: ``[b, 1, sk]``
    per-batch key padding, ``[sq, sk]`` shared by the batch, or anything
    broadcastable to ``[b, 1, sq, sk]``; True (nonzero) = masked, or an
    additive float mask (-inf = masked) with ``mask_additive``. Returns
    the dropped probabilities in the input layout.
    """
    bh, sq, sk = inputs.shape
    if bh % heads:
        raise ValueError(f"leading dim {bh} not divisible by heads={heads}")
    b = bh // heads
    x = inputs.reshape(b, heads, sq, sk)
    if pad_mask is not None:
        pm = torch.as_tensor(pad_mask, device=inputs.device)
        if pm.dim() == 3:      # [b, 1, sk] -> [b, 1, 1, sk]
            pm = pm[:, :, None, :]
        elif pm.dim() == 2:    # [sq, sk] -> [1, 1, sq, sk]
            pm = pm[None, None]
        pm = pm.expand(b, 1, sq, sk)
        if mask_additive:
            # fp32 through the softmax: fp16 would overflow a -1e9 fill
            x32 = x.float() + pm.float()
            probs = scaled_masked_softmax(x32, None).to(inputs.dtype)
        else:
            probs = scaled_masked_softmax(x, pm != 0)
    else:
        probs = scaled_masked_softmax(x, None)
    if dropout_prob > 0.0 and is_training:
        if dropout_key is None:
            raise ValueError("dropout_prob > 0 requires dropout_key")
        probs = _inverted_dropout(probs, dropout_prob, dropout_key)
    return probs.reshape(bh, sq, sk)


class MaskSoftmaxDropout:
    """``multihead_attn.py:207`` (ref mask_softmax_dropout_func.py, the
    ``Function.apply`` shape): ``op(is_training, heads, inputs, pad_mask,
    mask_additive, dropout_prob, dropout_key=None)``."""

    def __call__(self, is_training, heads, inputs, pad_mask, mask_additive,
                 dropout_prob, dropout_key=None):
        return mask_softmax_dropout(
            inputs, pad_mask, heads=heads, mask_additive=mask_additive,
            dropout_prob=dropout_prob, is_training=is_training,
            dropout_key=dropout_key)


def _flatten(tree: Dict, prefix: str = "") -> Dict:
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = value
    return out


def load_flax_params(module: torch.nn.Module, params: Dict) -> None:
    """Copy the JAX module's flax params (a nested dict of numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, variables["params"])``)
    into ``module`` in place, cast to its params' device and dtype. The
    names and layouts are the flax module's, so nothing is reshaped;
    a missing or extra name raises."""
    flat = _flatten(params)
    state = {name: _device.from_numpy(arr, torch.device("cpu"))
             for name, arr in flat.items()}
    with torch.no_grad():
        module.load_state_dict(state, strict=True)
