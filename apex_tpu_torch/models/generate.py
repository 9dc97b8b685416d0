"""KV-cache autoregressive decoding (port of
``apex_tpu/models/generate.py``): the llama family, dense and MoE, and
GPT-2 (:func:`gpt2_generate`).

Prefill is one full-sequence pass through the flash-attention kernel that
also returns every layer's (rotated) k / v; decode attends one query
token against the cache with a plain fp32 softmax. GPT-2's LayerNorms
run the LayerNorm forward kernel in the prefill and in every decode
step. The decode attention is a
grouped einsum here as in the reference (``generate.py:52``): it is no
Pallas kernel there.

MoE configs route every token through its top-k experts with no
capacity drop (the training path's drops are a throughput artifact, not
an inference semantic): the prefill runs every expert on every token,
masked by the combine weights; a decode step gathers each token's k
experts' weights and runs only those, as the reference does.

Greedy (``temperature=0``) or temperature sampling from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models import llama as _llama
from apex_tpu_torch.models._common import layer_norm as _ln
from apex_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["greedy_generate", "generate", "gpt2_generate"]


def _decode_attention(q, k_cache, v_cache, pos):
    """q [b, 1, nq, d] vs cache [b, max_len, nkv, d], valid idx <= pos.

    GQA contracts grouped (query head n = kv * rep + r) against the
    nkv-head cache, with no repeated copy. ``pos`` is an int or a tensor
    broadcastable against [b, nq, max_len] (e.g. [b, 1, 1] per-row
    positions for the serving scheduler's packed batches). Returns
    [b, 1, nq, d] in fp32.
    """
    b, _, nq, d = q.shape
    nkv = k_cache.shape[2]
    rep = nq // nkv
    qg = q.float().reshape(b, nkv, rep, d)
    scores = torch.einsum("bkrd,btkd->bkrt", qg,
                          k_cache.float()) * (d ** -0.5)
    scores = scores.reshape(b, nq, -1)            # [b, nq, T]
    idx = torch.arange(k_cache.shape[1], device=q.device)
    scores = torch.where(idx[None, None, :] <= pos, scores,
                         torch.full_like(scores, float("-inf")))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkrt,btkd->bkrd", probs.reshape(b, nkv, rep, -1),
                     v_cache.float())
    return o.reshape(b, 1, nq, d)


def _moe_router_weights(xt, lp, cfg):
    """Top-k combine weights on [T, h] tokens (``generate.py:78``): the
    training router's selection and normalisation, without its capacity
    drop. Returns (gate [T, k] fp32, idx [T, k])."""
    logits = torch.matmul(xt.float(), lp["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    if cfg.moe_top_k > 1:  # GShard/Mixtral renorm; top-1 keeps raw prob
        gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True),
                                  min=1e-9)
    return gate, idx


def _moe_decode_ffn(hm, lp, cfg):
    """Routed SwiGLU for one decode token a batch row ([b, 1, h];
    ``generate.py:93``): gather each token's top-k experts' weights
    ([b, k, h, f]) and run only those."""
    b, _, h = hm.shape
    xt = hm.reshape(b, h)
    gate, idx = _moe_router_weights(xt, lp, cfg)
    wg = lp["wg"][idx].to(xt.dtype)                       # [b, k, h, f]
    wu = lp["wu"][idx].to(xt.dtype)
    wd = lp["wd"][idx].to(xt.dtype)                       # [b, k, f, h]
    g = torch.einsum("bh,bkhf->bkf", xt, wg)
    u = torch.einsum("bh,bkhf->bkf", xt, wu)
    y = torch.einsum("bkf,bkfh->bkh", F.silu(g) * u, wd)
    out = torch.einsum("bk,bkh->bh", gate.to(xt.dtype), y)
    return out.reshape(b, 1, h)


def _moe_prefill_ffn(hm, lp, cfg):
    """Routed SwiGLU on the whole prompt [b, s, h] (``generate.py:112``):
    every expert on every token, masked by the combine weights. Exact
    (no capacity drop), E/k times the routed work."""
    b, s, h = hm.shape
    xt = hm.reshape(-1, h)
    gate, idx = _moe_router_weights(xt, lp, cfg)
    w = torch.sum(F.one_hot(idx, cfg.num_experts).float()
                  * gate[..., None], dim=1)               # [T, E]
    g = torch.einsum("th,ehf->tef", xt, lp["wg"].to(xt.dtype))
    u = torch.einsum("th,ehf->tef", xt, lp["wu"].to(xt.dtype))
    y = torch.einsum("tef,efh->teh", F.silu(g) * u, lp["wd"].to(xt.dtype))
    out = torch.einsum("te,teh->th", w.to(xt.dtype), y)
    return out.reshape(b, s, h)


def _ffn(cfg, moe_ffn):
    """The decoder layer's ``ffn`` argument: ``moe_ffn`` bound to
    ``cfg`` for an MoE config, None (the dense SwiGLU) otherwise."""
    if not cfg.moe:
        return None
    return lambda h, lp: moe_ffn(h, lp, cfg)


def _decode_layer(x, lp, cfg, k_cache, v_cache, pos: int):
    """One decode step through one layer. Writes this token's k / v into
    the caches in place (the reference returns updated caches)."""
    def attend(q, k, v):
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        return _decode_attention(q, k_cache, v_cache, pos).to(x.dtype)

    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    return _llama.decoder_layer(x, lp, cfg, positions, attend,
                                ffn=_ffn(cfg, _moe_decode_ffn))[0]


def _prefill_layer(x, lp, cfg, positions, mm=_llama.matmul, sc=None):
    """Full-sequence layer pass that also returns rotated k / v; ``mm``
    and ``sc`` as in :func:`~apex_tpu_torch.models.llama.decoder_layer`
    (an MoE layer's experts take plain products)."""
    return _llama.decoder_layer(x, lp, cfg, positions,
                                _llama.causal_attention, mm, sc,
                                ffn=_ffn(cfg, _moe_prefill_ffn))


def _sample(logits, temperature: float,
            generator: Optional[torch.Generator]):
    if temperature:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)  # first index on a tie


def _check_args(params, temperature: float,
                generator: Optional[torch.Generator],
                device: _device.DeviceLike):
    """The run's device, and the generator to sample from there."""
    if temperature and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    dev = _device.resolve(device)
    held = _device.of(params)
    if held is not None and held.type != dev.type:
        raise ValueError(f"params live on {held}, generate runs on {dev}")
    if generator is not None:
        generator = _device.generator_on(generator, dev)
    return dev, generator


def _autoregress(prompt_tokens, logits0, decode_step, max_new_tokens: int,
                 temperature: float, generator):
    """The shared decode loop (``generate.py:203``): the first token from
    the prefill's logits, then ``max_new_tokens - 1`` calls of
    ``decode_step(token [b, 1], pos) -> logits [b, vocab]``."""
    p = prompt_tokens.shape[1]
    token = _sample(logits0, temperature, generator)[:, None]
    new = [token]
    for pos in range(p, p + max_new_tokens - 1):
        token = _sample(decode_step(token, pos), temperature,
                        generator)[:, None]
        new.append(token)
    return torch.cat([prompt_tokens] + [t.to(prompt_tokens.dtype)
                                        for t in new], dim=1)


@torch.no_grad()
def generate(params, prompt_tokens: torch.Tensor, cfg, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: _device.DeviceLike = None) -> torch.Tensor:
    """Llama autoregressive decode: prompt [b, p] -> tokens [b, p + new].

    Greedy at ``temperature=0`` (default); otherwise softmax sampling
    from ``generator``. The prompt must be dense (no padding); the cache
    holds ``p + max_new_tokens`` positions. Runs on ``device`` (default:
    the GPU, raising when there is none), where the params must lie. MoE
    configs route every token with no capacity drop.
    """
    dev, generator = _check_args(params, temperature, generator, device)
    prompt_tokens = prompt_tokens.to(dev)
    b, p = prompt_tokens.shape
    positions = torch.arange(p, device=dev).expand(b, p)
    x = _llama.embed(params, prompt_tokens, cfg)
    max_len = p + max_new_tokens
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
    k_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    v_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    for i in range(cfg.num_layers):
        x, k, v = _prefill_layer(x, _llama.layer(params, i), cfg, positions)
        k_cache[i, :, :p] = k
        v_cache[i, :, :p] = v

    def decode_step(token, pos):
        x = _llama.embed(params, token, cfg)
        for i in range(cfg.num_layers):
            x = _decode_layer(x, _llama.layer(params, i), cfg, k_cache[i],
                              v_cache[i], pos)
        return _llama.lm_head(params, x, cfg)[:, 0]

    logits0 = _llama.lm_head(params, x[:, -1:], cfg)[:, 0]
    return _autoregress(prompt_tokens, logits0, decode_step, max_new_tokens,
                        temperature, generator)


def greedy_generate(params, prompt_tokens, cfg, max_new_tokens: int,
                    device: _device.DeviceLike = None):
    return generate(params, prompt_tokens, cfg, max_new_tokens,
                    temperature=0.0, device=device)


# ------------------------------------------------------------------- gpt2


def _gpt2_qkv(x, lp, cfg):
    """Packed q|k|v projection (``generate.py:264``): [b, s, h] -> three
    [b, s, n, d]."""
    b, s, h = x.shape
    n, d = cfg.num_heads, cfg.head_dim
    qkv = (torch.matmul(x, lp["wqkv"].reshape(h, -1).to(x.dtype))
           + lp["bqkv"].reshape(-1))
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    return (q.reshape(b, s, n, d), k.reshape(b, s, n, d),
            v.reshape(b, s, n, d))


def _gpt2_mlp(x, lp):
    y = torch.matmul(x, lp["wfc"].to(x.dtype)) + lp["bfc"]
    y = F.gelu(y, approximate="tanh")
    return torch.matmul(y, lp["wproj"].to(x.dtype)) + lp["bproj"]


def _gpt2_prefill_layer(x, lp, cfg):
    """One layer over the whole prompt: LayerNorm kernels and the flash
    forward (causal); returns (x, k, v)."""
    b, s = x.shape[:2]
    h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
    q, k, v = _gpt2_qkv(h, lp, cfg)
    o = flash_attention(q, k, v, causal=True, scale=cfg.head_dim ** -0.5)
    x = x + (torch.matmul(o.reshape(b, s, -1), lp["wo"].to(x.dtype))
             + lp["bo"])
    h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
    return x + _gpt2_mlp(h, lp), k, v


def _gpt2_decode_layer(x, lp, cfg, k_cache, v_cache, pos: int):
    """One decode step through one layer; writes this token's k / v into
    the caches in place (the reference returns updated caches)."""
    b = x.shape[0]
    h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
    q, k, v = _gpt2_qkv(h, lp, cfg)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    o = _decode_attention(q, k_cache, v_cache, pos).to(x.dtype)
    x = x + (torch.matmul(o.reshape(b, 1, -1), lp["wo"].to(x.dtype))
             + lp["bo"])
    h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
    return x + _gpt2_mlp(h, lp)


@torch.no_grad()
def gpt2_generate(params, prompt_tokens: torch.Tensor, cfg,
                  max_new_tokens: int, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  device: _device.DeviceLike = None) -> torch.Tensor:
    """GPT-2 decode (``generate.py:316``; learned positions, packed qkv,
    tied head): prompt [b, p] -> tokens [b, p + new]. Greedy at
    ``temperature=0``, else sampling from ``generator``. Runs on
    ``device`` (default: the GPU, raising when there is none)."""
    b, p = prompt_tokens.shape
    max_len = p + max_new_tokens
    if max_len > cfg.max_seq_len:
        raise ValueError(f"prompt + new tokens ({max_len}) exceeds "
                         f"max_seq_len {cfg.max_seq_len}")
    dev, generator = _check_args(params, temperature, generator, device)
    prompt_tokens = prompt_tokens.to(dev)
    layers = params["layers"]

    def layer(i):
        return {name: w[i] for name, w in layers.items()}

    def embed(tokens, pos0: int):
        x = params["embed"][tokens]
        wpe = params["pos_embed"][pos0:pos0 + tokens.shape[1]]
        return (x + wpe[None]).to(cfg.dtype)

    def logits_fn(x):
        x = _ln(x, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
        return torch.matmul(x, params["embed"].T.to(x.dtype)).float()

    x = embed(prompt_tokens, 0)
    shape = (cfg.num_layers, b, max_len, cfg.num_heads, cfg.head_dim)
    k_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    v_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    for i in range(cfg.num_layers):
        x, k, v = _gpt2_prefill_layer(x, layer(i), cfg)
        k_cache[i, :, :p] = k
        v_cache[i, :, :p] = v

    def decode_step(token, pos):
        x = embed(token, pos)
        for i in range(cfg.num_layers):
            x = _gpt2_decode_layer(x, layer(i), cfg, k_cache[i], v_cache[i],
                                   pos)
        return logits_fn(x)[:, 0]

    return _autoregress(prompt_tokens, logits_fn(x[:, -1:])[:, 0],
                        decode_step, max_new_tokens, temperature, generator)
