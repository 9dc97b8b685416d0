"""BERT family, single-device (port of ``apex_tpu/models/bert.py``).

The reference's BERT-base FusedLAMB + FusedLayerNorm benchmark model: a
post-norm bidirectional encoder with learned positions and token types,
packed-qkv attention through the padding-masked fused softmax, an
exact-GELU MLP, and a masked-LM head tied to the embedding. Params are a
dict of tensors in the reference's layout, so :func:`params_from_numpy`
takes the JAX package's params with no reshape. LayerNorm and the masked
softmax go through the port's kernels, forward and backward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models import _common
from apex_tpu_torch.models._common import (
    fan_in_normal,
    layer_norm,
    packed_mlp,
    packed_qkv_attention,
)
from apex_tpu_torch.transformer.functional.chunked_ce import (
    chunked_lm_cross_entropy,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    scaled_masked_softmax,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528  # 30522 padded for tp/tile divisibility
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    num_types: int = 2
    ln_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_base(**over) -> BertConfig:
    return BertConfig(**over)


def tiny(**over) -> BertConfig:
    """Test-scale config."""
    kw = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=torch.float32)
    kw.update(over)
    return BertConfig(**kw)


def init_params(generator: torch.Generator, cfg: BertConfig,
                device: _device.DeviceLike = None) -> Dict:
    """Random params from ``generator`` (drawn on its device), placed on
    ``device`` (default: the GPU, raising when there is none). Same
    layout and init law as the reference; not the same numbers."""
    device = _device.resolve(device)
    h, L, dt = cfg.hidden_size, cfg.num_layers, cfg.dtype

    def norm(*shape, fan_in=None):
        return fan_in_normal(generator, *shape, fan_in=fan_in,
                             dtype=dt).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "embed": norm(cfg.vocab_size, h, fan_in=h),
        "pos_embed": norm(cfg.max_seq_len, h, fan_in=h),
        "type_embed": norm(cfg.num_types, h, fan_in=h),
        "emb_ln_w": ones(h), "emb_ln_b": zeros(h),
        "layers": {
            "wqkv": norm(L, h, 3, h, fan_in=h), "bqkv": zeros(L, 3, h),
            "wo": norm(L, h, h), "bo": zeros(L, h),
            "ln1_w": ones(L, h), "ln1_b": zeros(L, h),
            "wfc": norm(L, h, 4 * h), "bfc": zeros(L, 4 * h),
            "wproj": norm(L, 4 * h, h), "bproj": zeros(L, h),
            "ln2_w": ones(L, h), "ln2_b": zeros(L, h),
        },
        "mlm_dense": norm(h, h),
        "mlm_bias": zeros(h),
        "mlm_ln_w": ones(h), "mlm_ln_b": zeros(h),
    }


def params_from_numpy(tree, device: _device.DeviceLike = None) -> Dict:
    """The JAX package's params as numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's, with
    no reshape; bf16 converts bit for bit."""
    return _device.from_numpy(tree, _device.resolve(device))


def _gelu(y):
    return F.gelu(y)  # exact (erf) GELU, bert.py:129


def encoder_layer(x, lp, cfg: BertConfig, pad_mask=None):
    """Post-norm block (the original BERT residual order). ``pad_mask``
    [b, s], True = a padding key, which the attention masks out."""
    mask = None if pad_mask is None else pad_mask[:, None, None, :]

    def padding_softmax(scores, scale):
        return scaled_masked_softmax(scores, mask, scale)

    a = packed_qkv_attention(x, lp, cfg.num_heads, cfg.head_dim,
                             padding_softmax)
    x = layer_norm(x + a, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
    return layer_norm(x + packed_mlp(x, lp, _gelu), lp["ln2_w"],
                      lp["ln2_b"], cfg.ln_eps)


def forward(params, tokens, cfg: BertConfig, type_ids=None, pad_mask=None,
            remat: bool = True):
    """tokens [b, s] -> hidden states [b, s, h]."""
    s = tokens.shape[1]
    x = vocab_parallel_embedding(tokens, params["embed"])
    x = x + params["pos_embed"][None, :s]
    if type_ids is None:
        x = x + params["type_embed"][0]
    else:
        x = x + F.embedding(type_ids, params["type_embed"])
    x = layer_norm(x.to(cfg.dtype), params["emb_ln_w"], params["emb_ln_b"],
                   cfg.ln_eps)

    def body(h, lp):
        return encoder_layer(h, lp, cfg, pad_mask)

    return _common.run_stacked(x, params["layers"], cfg.num_layers, body,
                               remat)


def mlm_transform(params, hidden, cfg: BertConfig):
    """The pre-decoder MLM head transform: dense + gelu + LayerNorm."""
    x = torch.matmul(hidden, params["mlm_dense"].to(hidden.dtype))
    x = _gelu(x + params["mlm_bias"])
    return layer_norm(x, params["mlm_ln_w"], params["mlm_ln_b"], cfg.ln_eps)


def mlm_logits(params, hidden, cfg: BertConfig):
    """Masked-LM head, tied decoder -> fp32 [b, s, vocab]; an optional
    ``mlm_decoder_bias`` [vocab] (HF BERT's cls.predictions.bias) adds
    per-vocab offsets when present."""
    x = mlm_transform(params, hidden, cfg)
    logits = torch.matmul(x, params["embed"].T.to(x.dtype)).float()
    if "mlm_decoder_bias" in params:
        logits = logits + params["mlm_decoder_bias"].float()
    return logits


def loss_fn(params, batch, cfg: BertConfig, type_ids=None, pad_mask=None,
            remat: bool = True,
            vocab_chunks: Optional[int] = None) -> torch.Tensor:
    """MLM loss; ``batch = (tokens, targets, loss_mask)``: ``loss_mask``
    selects the positions the CE averages over. ``pad_mask`` (True =
    padding) masks attention. ``vocab_chunks`` streams the tied decoder
    and the CE without the fp32 [b*s, vocab] logits (``bert.py:195``)."""
    tokens, targets, loss_mask = batch
    hidden = forward(params, tokens, cfg, type_ids=type_ids,
                     pad_mask=pad_mask, remat=remat)
    if vocab_chunks:
        x = mlm_transform(params, hidden, cfg)
        losses = chunked_lm_cross_entropy(
            x.reshape(-1, x.shape[-1]), params["embed"].T,
            targets.reshape(-1), vocab_chunks,
            bias=params.get("mlm_decoder_bias")).reshape(targets.shape)
    else:
        losses = vocab_parallel_cross_entropy(
            mlm_logits(params, hidden, cfg), targets)
    denom = torch.clamp(torch.sum(loss_mask), min=1.0)
    return torch.sum(losses * loss_mask) / denom


def train_step(params, opt_state, batch, cfg: BertConfig, tx,
               type_ids=None, pad_mask=None, remat: bool = True,
               vocab_chunks: Optional[int] = None):
    """One training step of :func:`loss_fn` (``_common.train_step``), as
    ``bench.py``'s BERT step: ``(params, opt_state, loss)``, the params
    updated in place."""
    return _common.train_step(
        params, opt_state, tx,
        lambda live: loss_fn(live, batch, cfg, type_ids=type_ids,
                             pad_mask=pad_mask, remat=remat,
                             vocab_chunks=vocab_chunks))
