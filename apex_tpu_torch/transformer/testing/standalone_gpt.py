"""Standalone GPT for the pipeline tests (port of
``apex_tpu/transformer/testing/standalone_gpt.py``, after Apex's
``apex/transformer/testing/standalone_gpt.py``).

Apex carries a Megatron GPT to test its schedules without Megatron-LM;
``apex_tpu_torch.models.gpt2`` is that model here, adapted to the
harness: a config from the ``get_args`` flags, the layers split into
pipeline stages, and the embed / stage / head pieces the pipeline
schedules take. With ``tp_axis`` bound each piece runs
tensor-parallel on this rank's shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.models import gpt2
from apex_tpu_torch.models._common import bound_tp, layer_norm, tied_logits
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.commons import (  # noqa: F401
    io_params,
    split_stages,
)


def params_dtype(args) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        args.params_dtype, torch.float32)


def gpt_config_from_args(args) -> gpt2.GPT2Config:
    """The harness's flags as a ``GPT2Config``."""
    return gpt2.GPT2Config(
        vocab_size=args.padded_vocab_size, hidden_size=args.hidden_size,
        num_layers=args.num_layers, num_heads=args.num_attention_heads,
        max_seq_len=args.max_position_embeddings,
        ln_eps=args.layernorm_epsilon, dtype=params_dtype(args))


def embed(io, tokens, cfg: gpt2.GPT2Config, tp_axis: Optional[str] = "tp"):
    """The first stage's input: token plus position embeddings."""
    return gpt2.embed(io, tokens, cfg, tp_axis)


def stage_fn(stage_params, x, cfg: gpt2.GPT2Config,
             tp_axis: Optional[str] = "tp"):
    """One pipeline stage: this stage's decoder layers in turn."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = gpt2.decoder_layer(x, {k: v[i] for k, v in stage_params.items()},
                               cfg, tp_axis)
    return x


def head_loss(io, x, targets, cfg: gpt2.GPT2Config,
              tp_axis: Optional[str] = "tp"):
    """The last stage's output: final LayerNorm, the tied head and the
    (vocab-parallel) cross entropy's mean."""
    x = layer_norm(x, io["lnf_w"], io["lnf_b"], cfg.ln_eps)
    tp = bound_tp(tp_axis)
    return torch.mean(vocab_parallel_cross_entropy(
        tied_logits(x, io["embed"], tp), targets, axis_name=tp_axis,
        local=tp is None))


def gpt_model_provider(args=None):
    """``standalone_gpt.py:gpt_model_provider``: ``(cfg, init_params,
    split_stages, embed, stage_fn, head_loss)``."""
    if args is None:
        from apex_tpu_torch.transformer.testing.global_vars import get_args

        args = get_args()
    return (gpt_config_from_args(args), gpt2.init_params, split_stages,
            embed, stage_fn, head_loss)
