"""Standalone BERT for the pipeline tests (port of
``apex_tpu/transformer/testing/standalone_bert.py``, after Apex's
``apex/transformer/testing/standalone_bert.py``): ``models.bert``
adapted to the harness as ``standalone_gpt`` adapts GPT-2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.models import bert
from apex_tpu_torch.models._common import (
    bound_tp,
    layer_norm,
    token_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.commons import (  # noqa: F401
    io_params,
    split_stages,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import params_dtype


def bert_config_from_args(args) -> bert.BertConfig:
    """The harness's flags as a ``BertConfig``."""
    return bert.BertConfig(
        vocab_size=args.padded_vocab_size, hidden_size=args.hidden_size,
        num_layers=args.num_layers, num_heads=args.num_attention_heads,
        max_seq_len=args.max_position_embeddings,
        ln_eps=args.layernorm_epsilon, dtype=params_dtype(args))


def embed(io, tokens, cfg: bert.BertConfig, type_ids=None,
          tp_axis: Optional[str] = "tp"):
    """Token, position and type embeddings, then the embedding LayerNorm."""
    s = tokens.shape[-1]
    x = token_embedding(tokens, io["embed"], bound_tp(tp_axis))
    x = x + io["pos_embed"][None, :s]
    if type_ids is None:
        x = x + io["type_embed"][0]
    else:
        x = x + F.embedding(type_ids, io["type_embed"])
    return layer_norm(x.to(cfg.dtype), io["emb_ln_w"], io["emb_ln_b"],
                      cfg.ln_eps)


def stage_fn(stage_params, x, cfg: bert.BertConfig, pad_mask=None,
             tp_axis: Optional[str] = "tp"):
    """One pipeline stage: this stage's encoder layers in turn."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = bert.encoder_layer(x, {k: v[i] for k, v in stage_params.items()},
                               cfg, pad_mask, tp_axis)
    return x


def head_loss(io, x, targets, loss_mask, cfg: bert.BertConfig,
              tp_axis: Optional[str] = "tp"):
    """The MLM head over the final hidden states and the masked cross
    entropy's mean over ``loss_mask``."""
    tp = bound_tp(tp_axis)
    ce = vocab_parallel_cross_entropy(bert.mlm_logits(io, x, cfg, tp),
                                      targets, axis_name=tp_axis,
                                      local=tp is None)
    return torch.sum(ce * loss_mask) / torch.clamp(torch.sum(loss_mask),
                                                   min=1.0)


def bert_model_provider(args=None):
    """``standalone_bert.py:bert_model_provider``."""
    if args is None:
        from apex_tpu_torch.transformer.testing.global_vars import get_args

        args = get_args()
    return (bert_config_from_args(args), bert.init_params, split_stages,
            embed, stage_fn, head_loss)
