"""Megatron-style argument parser (port of
``apex_tpu/transformer/testing/arguments.py``, after Apex's
``apex/transformer/testing/arguments.py``).

The core of the Megatron-LM parser that the harness's tests read (model
shape, batch and microbatch sizes, parallel sizes, mixed precision,
seed), under the same flag spellings and validation rules; other flags
are accepted and ignored through ``parse_known_args``.
"""

from __future__ import annotations

import argparse


def parse_args(extra_args_provider=None, defaults=None,
               ignore_unknown_args: bool = True, args=None):
    """Ref arguments.py:parse_args (core subset, same flag spellings)."""
    parser = argparse.ArgumentParser(description="apex_tpu_torch testing args",
                                     allow_abbrev=False)

    g = parser.add_argument_group("model")
    g.add_argument("--num-layers", type=int, default=4)
    g.add_argument("--hidden-size", type=int, default=64)
    g.add_argument("--num-attention-heads", type=int, default=4)
    g.add_argument("--ffn-hidden-size", type=int, default=None)
    g.add_argument("--kv-channels", type=int, default=None)
    g.add_argument("--seq-length", type=int, default=32)
    g.add_argument("--max-position-embeddings", type=int, default=None)
    g.add_argument("--padded-vocab-size", type=int, default=128)
    g.add_argument("--layernorm-epsilon", type=float, default=1e-5)

    g = parser.add_argument_group("training")
    g.add_argument("--micro-batch-size", type=int, default=2)
    g.add_argument("--global-batch-size", type=int, default=None)
    g.add_argument("--rampup-batch-size", nargs="*", default=None)
    g.add_argument("--train-iters", type=int, default=10)
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--weight-decay", type=float, default=0.01)
    g.add_argument("--clip-grad", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=1234)

    g = parser.add_argument_group("parallelism")
    g.add_argument("--tensor-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    g.add_argument(
        "--virtual-pipeline-model-parallel-size", type=int, default=None)
    g.add_argument("--context-parallel-size", type=int, default=1)
    g.add_argument("--sequence-parallel", action="store_true")
    g.add_argument("--use-cpu-initialization", action="store_true")

    g = parser.add_argument_group("mixed precision")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--loss-scale", type=float, default=None)
    g.add_argument("--initial-loss-scale", type=float, default=2.0 ** 16)
    g.add_argument("--loss-scale-window", type=int, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)

    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        parsed, _ = parser.parse_known_args(args)
    else:
        parsed = parser.parse_args(args)

    for key, value in (defaults or {}).items():
        key = key.replace("-", "_")
        if getattr(parsed, key, None) is None or key not in vars(parsed):
            setattr(parsed, key, value)

    # derived values + validation (ref arguments.py post-parse block)
    if parsed.ffn_hidden_size is None:
        parsed.ffn_hidden_size = 4 * parsed.hidden_size
    if parsed.kv_channels is None:
        if parsed.hidden_size % parsed.num_attention_heads:
            raise ValueError(
                "num_attention_heads must divide hidden_size evenly")
        parsed.kv_channels = parsed.hidden_size // parsed.num_attention_heads
    if parsed.max_position_embeddings is None:
        parsed.max_position_embeddings = parsed.seq_length
    if parsed.fp16 and parsed.bf16:
        raise ValueError("fp16 and bf16 are mutually exclusive")
    parsed.params_dtype = ("float16" if parsed.fp16
                           else "bfloat16" if parsed.bf16 else "float32")

    mp = (parsed.tensor_model_parallel_size
          * parsed.pipeline_model_parallel_size)
    parsed.model_parallel_size = mp
    if parsed.global_batch_size is None:
        parsed.global_batch_size = parsed.micro_batch_size
    if parsed.virtual_pipeline_model_parallel_size is not None:
        if parsed.num_layers % (
                parsed.pipeline_model_parallel_size
                * parsed.virtual_pipeline_model_parallel_size):
            raise ValueError(
                "num_layers must divide pp_size * virtual_pp_size")
    return parsed
