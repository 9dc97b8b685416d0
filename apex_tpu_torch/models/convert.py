"""HuggingFace checkpoint import for the model zoo (port of
``apex_tpu/models/convert.py``): ``transformers`` state dicts to the
port's param trees, in the reference's layout.

- llama: HF ``rotate_half`` RoPE is the port's rope; a torch ``Linear``
  stores [out, in], so projections transpose; per-layer tensors stack on
  dim 0.
- gpt2: HF ``Conv1D`` already stores [in, out]; ``c_attn``'s packed
  q|k|v [h, 3h] reshapes straight into ``wqkv`` [h, 3, h].
- bert: q, k and v stack into ``wqkv`` [h, 3, h]; the decoder bias
  (``cls.predictions.bias``) lands as ``mlm_decoder_bias``.

Pass a ``transformers`` model (weights read through ``state_dict()``) or
any mapping of parameter names to tensors or arrays. The params land on
``device`` (default: the GPU, raising when there is none) in
``cfg.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.models import bert as _bert
from apex_tpu_torch.models import gpt2 as _gpt2
from apex_tpu_torch.models import llama as _llama

__all__ = [
    "bert_config_from_hf",
    "bert_from_hf",
    "llama_config_from_hf",
    "llama_from_hf",
    "gpt2_config_from_hf",
    "gpt2_from_hf",
]


def _state_dict(model_or_sd) -> Mapping[str, torch.Tensor]:
    """Every weight as an fp32 tensor (the reference reads fp32 numpy
    arrays): a tensor stays on its device, so a state dict made on the
    card is converted there; an array lands on the CPU."""
    sd = (model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict")
          else model_or_sd)
    return {k: torch.as_tensor(v).detach().to(torch.float32)
            for k, v in sd.items()}


def _stack(sd, fmt, n_layers, transpose=False):
    mats = [sd[fmt.format(i)] for i in range(n_layers)]
    if transpose:
        mats = [m.T for m in mats]
    return torch.stack(mats)


def _with_dtype(cfg, dtype):
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _place(tree, cfg, device):
    """``tree`` in ``cfg.dtype`` on ``device``, each tensor contiguous."""
    dev = _device.resolve(device)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        return node.to(device=dev, dtype=cfg.dtype).contiguous()

    return place(tree)


# ------------------------------------------------------------------ llama


def llama_config_from_hf(hf_config) -> "_llama.LlamaConfig":
    return _llama.LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=(hf_config.num_key_value_heads
                      or hf_config.num_attention_heads),
        max_seq_len=hf_config.max_position_embeddings,
        rms_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings",
                                    False)),
    )


def llama_from_hf(model_or_sd, cfg: "_llama.LlamaConfig" = None,
                  dtype=None, device: _device.DeviceLike = None):
    """HF ``LlamaForCausalLM`` (or its state dict) -> ``(params, cfg)``."""
    if cfg is None:
        cfg = llama_config_from_hf(model_or_sd.config)
    cfg = _with_dtype(cfg, dtype)
    sd = _state_dict(model_or_sd)
    L = cfg.num_layers
    p = "model.layers.{}."
    layers = {
        "attn_norm": _stack(sd, p + "input_layernorm.weight", L),
        "wq": _stack(sd, p + "self_attn.q_proj.weight", L, transpose=True),
        "wk": _stack(sd, p + "self_attn.k_proj.weight", L, transpose=True),
        "wv": _stack(sd, p + "self_attn.v_proj.weight", L, transpose=True),
        "wo": _stack(sd, p + "self_attn.o_proj.weight", L, transpose=True),
        "mlp_norm": _stack(sd, p + "post_attention_layernorm.weight", L),
        "wg": _stack(sd, p + "mlp.gate_proj.weight", L, transpose=True),
        "wu": _stack(sd, p + "mlp.up_proj.weight", L, transpose=True),
        "wd": _stack(sd, p + "mlp.down_proj.weight", L, transpose=True),
    }
    params = {
        "embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm": sd["model.norm.weight"],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
    return _place(params, cfg, device), cfg


# ------------------------------------------------------------------- gpt2


def gpt2_config_from_hf(hf_config) -> "_gpt2.GPT2Config":
    return _gpt2.GPT2Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        max_seq_len=hf_config.n_positions,
        ln_eps=hf_config.layer_norm_epsilon,
    )


def gpt2_from_hf(model_or_sd, cfg: "_gpt2.GPT2Config" = None, dtype=None,
                 device: _device.DeviceLike = None):
    """HF ``GPT2LMHeadModel`` (or its state dict) -> ``(params, cfg)``."""
    if cfg is None:
        cfg = gpt2_config_from_hf(model_or_sd.config)
    cfg = _with_dtype(cfg, dtype)
    sd = {k.removeprefix("transformer."): v
          for k, v in _state_dict(model_or_sd).items()}
    L, h = cfg.num_layers, cfg.hidden_size
    p = "h.{}."
    layers = {
        "ln1_w": _stack(sd, p + "ln_1.weight", L),
        "ln1_b": _stack(sd, p + "ln_1.bias", L),
        # Conv1D stores [in, out]: c_attn [h, 3h] -> [h, 3, h] is the
        # packed q|k|v layout
        "wqkv": _stack(sd, p + "attn.c_attn.weight", L).reshape(L, h, 3, h),
        "bqkv": _stack(sd, p + "attn.c_attn.bias", L).reshape(L, 3, h),
        "wo": _stack(sd, p + "attn.c_proj.weight", L),
        "bo": _stack(sd, p + "attn.c_proj.bias", L),
        "ln2_w": _stack(sd, p + "ln_2.weight", L),
        "ln2_b": _stack(sd, p + "ln_2.bias", L),
        "wfc": _stack(sd, p + "mlp.c_fc.weight", L),
        "bfc": _stack(sd, p + "mlp.c_fc.bias", L),
        "wproj": _stack(sd, p + "mlp.c_proj.weight", L),
        "bproj": _stack(sd, p + "mlp.c_proj.bias", L),
    }
    params = {
        "embed": sd["wte.weight"],
        "pos_embed": sd["wpe.weight"],
        "layers": layers,
        "lnf_w": sd["ln_f.weight"],
        "lnf_b": sd["ln_f.bias"],
    }
    return _place(params, cfg, device), cfg


# ------------------------------------------------------------------- bert


def bert_config_from_hf(hf_config) -> "_bert.BertConfig":
    return _bert.BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        max_seq_len=hf_config.max_position_embeddings,
        num_types=hf_config.type_vocab_size,
        ln_eps=hf_config.layer_norm_eps,
    )


def bert_from_hf(model_or_sd, cfg: "_bert.BertConfig" = None, dtype=None,
                 device: _device.DeviceLike = None):
    """HF ``BertForMaskedLM`` (or its state dict) -> ``(params, cfg)``."""
    if cfg is None:
        cfg = bert_config_from_hf(model_or_sd.config)
    cfg = _with_dtype(cfg, dtype)
    sd = _state_dict(model_or_sd)
    L = cfg.num_layers
    p = "bert.encoder.layer.{}."

    def qkv(i):
        return torch.stack([sd[p.format(i) + f"attention.self.{n}.weight"].T
                            for n in ("query", "key", "value")], dim=1)

    def bqkv(i):
        return torch.stack([sd[p.format(i) + f"attention.self.{n}.bias"]
                            for n in ("query", "key", "value")])

    layers = {
        "wqkv": torch.stack([qkv(i) for i in range(L)]),
        "bqkv": torch.stack([bqkv(i) for i in range(L)]),
        "wo": _stack(sd, p + "attention.output.dense.weight", L,
                     transpose=True),
        "bo": _stack(sd, p + "attention.output.dense.bias", L),
        "ln1_w": _stack(sd, p + "attention.output.LayerNorm.weight", L),
        "ln1_b": _stack(sd, p + "attention.output.LayerNorm.bias", L),
        "wfc": _stack(sd, p + "intermediate.dense.weight", L,
                      transpose=True),
        "bfc": _stack(sd, p + "intermediate.dense.bias", L),
        "wproj": _stack(sd, p + "output.dense.weight", L, transpose=True),
        "bproj": _stack(sd, p + "output.dense.bias", L),
        "ln2_w": _stack(sd, p + "output.LayerNorm.weight", L),
        "ln2_b": _stack(sd, p + "output.LayerNorm.bias", L),
    }
    params = {
        "embed": sd["bert.embeddings.word_embeddings.weight"],
        "pos_embed": sd["bert.embeddings.position_embeddings.weight"],
        "type_embed": sd["bert.embeddings.token_type_embeddings.weight"],
        "emb_ln_w": sd["bert.embeddings.LayerNorm.weight"],
        "emb_ln_b": sd["bert.embeddings.LayerNorm.bias"],
        "layers": layers,
        "mlm_dense": sd["cls.predictions.transform.dense.weight"].T,
        "mlm_bias": sd["cls.predictions.transform.dense.bias"],
        "mlm_ln_w": sd["cls.predictions.transform.LayerNorm.weight"],
        "mlm_ln_b": sd["cls.predictions.transform.LayerNorm.bias"],
        "mlm_decoder_bias": sd["cls.predictions.bias"],
    }
    return _place(params, cfg, device), cfg
