"""Llama model family, single-device (port of
``apex_tpu/models/llama.py``).

Params are a dict of tensors in the reference's layout: per-layer weights
stacked on a leading ``[L, ...]`` dim, projections stored ``(in, out)``.
So :func:`params_from_numpy` takes the JAX package's params as numpy
arrays with no reshape. Everything here is single-device (no tp/cp/ep,
no MoE): projections, SwiGLU and the lm head are ``torch.matmul``, as
the JAX package leaves them to XLA; RMSNorm and attention go through the
port's kernels, forward and backward.

Two paths share the decoder layer: :func:`forward` (no grad) serves, and
:func:`loss_fn` / :func:`train_step` train, the counterpart of the JAX
package's ``value_and_grad(loss_fn)`` -> ``fused_adam(...).update`` ->
``params + updates`` step (``bench.py:388-395``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models import _common
from apex_tpu_torch.models._common import fan_in_normal
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_rms_norm_affine,
)
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.functional.rope import apply_rotary_qk
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama3_8b(**over) -> LlamaConfig:
    return LlamaConfig(**over)


def flagship_0p9b(**over) -> LlamaConfig:
    kw = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
              num_layers=8, num_heads=16, num_kv_heads=8, max_seq_len=2048,
              dtype=torch.bfloat16)
    kw.update(over)
    return LlamaConfig(**kw)


def tiny(**over) -> LlamaConfig:
    """Test-scale config."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
              dtype=torch.float32)
    kw.update(over)
    return LlamaConfig(**kw)


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: _device.DeviceLike = None) -> Dict:
    """Random params from ``generator`` (drawn on its device), placed on
    ``device`` (default: the GPU, raising when there is none). Same
    layout and init law as the reference; not the same numbers, since
    torch and jax generators differ."""
    device = _device.resolve(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dt = cfg.dtype

    def norm(*shape, fan_in=None):
        return fan_in_normal(generator, *shape, fan_in=fan_in,
                             dtype=dt).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, h),
        "wq": norm(L, h, nq * d),
        "wk": norm(L, h, nkv * d),
        "wv": norm(L, h, nkv * d),
        "wo": norm(L, nq * d, h),
        "mlp_norm": ones(L, h),
        "wg": norm(L, h, i),
        "wu": norm(L, h, i),
        "wd": norm(L, i, h),
    }
    params = {
        "embed": norm(cfg.vocab_size, h, fan_in=h),
        "layers": layers,
        "final_norm": ones(h),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(h, cfg.vocab_size, fan_in=h)
    return params


def params_from_numpy(tree, device: _device.DeviceLike = None) -> Dict:
    """The JAX package's params (a nested dict of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's, with
    no reshape."""
    return _device.from_numpy(tree, _device.resolve(device))


def layer(params: Dict, idx: int) -> Dict:
    """One layer's (unstacked) params: a view of row ``idx`` of every
    stacked ``[L, ...]`` weight."""
    return {k: v[idx] for k, v in params["layers"].items()}


def _rmsnorm(x, w, eps):
    return fused_rms_norm_affine(x, w, (x.shape[-1],), eps=eps)


def _qkv(x, lp, cfg: LlamaConfig, positions):
    """Projections + rope on [b, s, h] -> q [b, s, nq, d], k / v
    [b, s, nkv, d]; ``positions`` [b, s] gives each row's own angles."""
    b, s, _ = x.shape
    d = cfg.head_dim
    q = torch.matmul(x, lp["wq"]).reshape(b, s, cfg.num_heads, d)
    k = torch.matmul(x, lp["wk"]).reshape(b, s, cfg.num_kv_heads, d)
    v = torch.matmul(x, lp["wv"]).reshape(b, s, cfg.num_kv_heads, d)
    q, k = apply_rotary_qk(q, k, positions=positions, base=cfg.rope_theta)
    return q, k, v


def causal_attention(q, k, v):
    """Self-attention of a whole sequence: the flash-forward kernel."""
    return flash_attention(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)


def decoder_layer(x, lp, cfg: LlamaConfig, positions, attend):
    """One pre-norm block on a single layer's params ``lp``.

    ``attend(q, k, v) -> o [b, s, nq, d]`` is the attention:
    :func:`causal_attention` for a whole sequence, a cache read for
    decode. Returns ``(x, k, v)`` with this layer's rotated k / v."""
    b, s, _ = x.shape
    h = _rmsnorm(x, lp["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(h, lp, cfg, positions)
    o = attend(q, k, v).reshape(b, s, -1)
    x = x + torch.matmul(o, lp["wo"])
    h = _rmsnorm(x, lp["mlp_norm"], cfg.rms_eps)
    g = torch.matmul(h, lp["wg"])
    u = torch.matmul(h, lp["wu"])
    return x + torch.matmul(torch.nn.functional.silu(g) * u, lp["wd"]), k, v


def embed(params, tokens, cfg: LlamaConfig):
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def lm_head_weight(params, cfg: LlamaConfig):
    """The [h, vocab] classifier kernel (embed.T when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head(params, x, cfg: LlamaConfig):
    """Final norm + logits [b, s, vocab]: a matmul in the activation
    dtype, then fp32 (``_logits`` of the reference's generate)."""
    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps)
    w = lm_head_weight(params, cfg)
    return torch.matmul(x, w.to(x.dtype)).float()


def run_layers(x, layers: Dict, cfg: LlamaConfig, positions,
               remat: Union[bool, str] = True):
    """Run the stacked ``[L, ...]`` layer weights over the residual
    stream ``x`` [b, s, h] (``run_layers``, ``llama.py:296``; no MoE, so
    no aux loss). ``remat`` as in :func:`_common.run_stacked`."""
    def body(h, lp):
        return decoder_layer(h, lp, cfg, positions, causal_attention)[0]

    return _common.run_stacked(x, layers, cfg.num_layers, body, remat)


def hidden_states(params, tokens, cfg: LlamaConfig,
                  remat: Union[bool, str] = True):
    """The shared trunk: embed + all decoder layers (pre-final-norm).
    tokens [b, s] -> hidden [b, s, h] (``llama.py:363``)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(params, tokens, cfg)
    return run_layers(x, params["layers"], cfg, positions, remat)


@torch.no_grad()
def forward(params, tokens, cfg: LlamaConfig):
    """tokens [b, s] -> logits [b, s, vocab] (fp32), with no autograd
    graph: the serving path's forward. :func:`loss_fn` is the
    differentiable one."""
    return lm_head(params, hidden_states(params, tokens, cfg, remat=False),
                   cfg)


def loss_fn(params, batch, cfg: LlamaConfig,
            remat: Union[bool, str] = True) -> torch.Tensor:
    """Mean next-token CE; ``batch = (tokens, targets)``, both [b, s]
    (``llama.py:399``, single-device and without ``vocab_chunks``)."""
    tokens, targets = batch
    logits = lm_head(params, hidden_states(params, tokens, cfg, remat), cfg)
    return torch.mean(vocab_parallel_cross_entropy(logits, targets))


def train_step(params, opt_state, batch, cfg: LlamaConfig, tx,
               remat: Union[bool, str] = False):
    """One training step of :func:`loss_fn` (``_common.train_step``):
    ``(params, opt_state, loss)``, the params updated in place."""
    return _common.train_step(
        params, opt_state, tx,
        lambda live: loss_fn(live, batch, cfg, remat=remat))
