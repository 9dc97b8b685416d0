"""GPT-2 family (port of ``apex_tpu/models/gpt2.py``).

The reference's GPT-2 345M benchmark model: a pre-norm transformer with
learned positions, packed-qkv attention through the causal fused
softmax, a tanh-GELU MLP, LayerNorm everywhere and a tied lm head.
Params are a dict of tensors in the reference's layout (per-layer
weights stacked ``[L, ...]``, projections ``(in, out)``, ``wqkv`` [L, h,
3, h]), so :func:`params_from_numpy` takes the JAX package's params with
no reshape. LayerNorm and the causal softmax go through the port's
kernels, forward and backward; the products are ``torch.matmul`` and
``torch.einsum``, as the JAX package leaves them to XLA.

Tensor parallelism: with a group bound to ``tp_axis`` (default ``"tp"``)
the params are this rank's shards (:func:`param_specs`): the packed qkv
and the fc kernels split their output dim, wo and the proj kernel their
input dim, the embedding its vocab rows; the layers run the reference's
column/row collectives, the embedding lookup and the cross entropy are
vocab-parallel, and each rank's causal softmax takes its
``num_heads / tp`` heads. Each rank's autograd gives the true gradients
of its shards and of what is replicated. With no group bound it is the
single-device path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models import _common
from apex_tpu_torch.models._common import (
    bound_tp,
    fan_in_normal,
    layer_norm,
    packed_mlp,
    packed_qkv_attention,
    tied_logits,
    token_embedding,
)
from apex_tpu_torch.transformer.functional.chunked_ce import (
    chunked_lm_cross_entropy,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 padded to a tp/128-friendly multiple
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 1024
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt2_345m(**over) -> GPT2Config:
    return GPT2Config(**over)


def tiny(**over) -> GPT2Config:
    """Test-scale config."""
    kw = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=torch.float32)
    kw.update(over)
    return GPT2Config(**kw)


def init_params(generator: torch.Generator, cfg: GPT2Config,
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
        "layers": {
            "ln1_w": ones(L, h), "ln1_b": zeros(L, h),
            "wqkv": norm(L, h, 3, h, fan_in=h), "bqkv": zeros(L, 3, h),
            "wo": norm(L, h, h), "bo": zeros(L, h),
            "ln2_w": ones(L, h), "ln2_b": zeros(L, h),
            "wfc": norm(L, h, 4 * h), "bfc": zeros(L, 4 * h),
            "wproj": norm(L, 4 * h, h), "bproj": zeros(L, h),
        },
        "lnf_w": ones(h), "lnf_b": zeros(h),
    }


def param_specs(cfg: GPT2Config, tp_axis: str = "tp") -> Dict:
    """The partition spec of each leaf of :func:`init_params`'s tree
    (``gpt2.py:93``) in the port's form: a tuple with one entry a dim,
    the axis a dim is split over or None; ``()`` replicates."""
    del cfg
    t = tp_axis
    return {
        "embed": (t, None), "pos_embed": (),
        "layers": {
            "ln1_w": (), "ln1_b": (),
            "wqkv": (None, None, None, t), "bqkv": (None, None, t),
            "wo": (None, t, None), "bo": (),
            "ln2_w": (), "ln2_b": (),
            "wfc": (None, None, t), "bfc": (None, t),
            "wproj": (None, t, None), "bproj": (),
        },
        "lnf_w": (), "lnf_b": (),
    }


def params_from_numpy(tree, device: _device.DeviceLike = None) -> Dict:
    """The JAX package's params as numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's, with
    no reshape; bf16 converts bit for bit."""
    return _device.from_numpy(tree, _device.resolve(device))


def _causal_softmax(scores, scale):
    b, n, s, sk = scores.shape
    return scaled_upper_triang_masked_softmax(
        scores.reshape(b * n, s, sk), None, scale).reshape(b, n, s, sk)


def _gelu(y):
    return F.gelu(y, approximate="tanh")


def decoder_layer(x, lp, cfg: GPT2Config, tp_axis: Optional[str] = "tp"):
    """One pre-norm block on a single layer's params ``lp`` (this rank's
    shards with ``tp_axis`` bound)."""
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
    x = x + packed_qkv_attention(h, lp, cfg.num_heads, cfg.head_dim,
                                 _causal_softmax, tp_axis)
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
    return x + packed_mlp(h, lp, _gelu, tp_axis)


def embed(params, tokens, cfg: GPT2Config, tp_axis: Optional[str] = "tp"):
    """Token (vocab-parallel with ``tp_axis`` bound) plus position
    embeddings, in ``cfg.dtype``."""
    s = tokens.shape[1]
    x = token_embedding(tokens, params["embed"], tp_axis)
    return (x + params["pos_embed"][None, :s]).to(cfg.dtype)


def hidden_states(params, tokens, cfg: GPT2Config,
                  remat: Union[bool, str] = True,
                  tp_axis: Optional[str] = "tp"):
    """The shared trunk: embeddings, all layers, final LayerNorm
    (pre-head). tokens [b, s] -> [b, s, h]."""
    x = embed(params, tokens, cfg, tp_axis)

    def body(h, lp):
        return decoder_layer(h, lp, cfg, tp_axis)

    x = _common.run_stacked(x, params["layers"], cfg.num_layers, body, remat)
    return layer_norm(x, params["lnf_w"], params["lnf_b"], cfg.ln_eps)


def forward(params, tokens, cfg: GPT2Config,
            remat: Union[bool, str] = True, tp_axis: Optional[str] = "tp"):
    """tokens [b, s] -> fp32 logits [b, s, vocab] (tied head); this
    rank's vocab slice [b, s, vocab/tp] with ``tp_axis`` bound."""
    x = hidden_states(params, tokens, cfg, remat, tp_axis)
    return tied_logits(x, params["embed"], tp_axis)


def loss_fn(params, batch, cfg: GPT2Config,
            remat: Union[bool, str] = True,
            vocab_chunks: Optional[int] = None,
            tp_axis: Optional[str] = "tp") -> torch.Tensor:
    """Mean next-token CE; ``batch = (tokens, targets)``, both [b, s].
    ``vocab_chunks`` streams the tied head and the CE so the fp32
    [b*s, vocab] logits never exist (``gpt2.py:168``). With ``tp_axis``
    bound the CE is vocab-parallel."""
    tokens, targets = batch
    tp = bound_tp(tp_axis)
    if vocab_chunks:
        x = hidden_states(params, tokens, cfg, remat, tp_axis)
        losses = chunked_lm_cross_entropy(
            x.reshape(-1, x.shape[-1]), params["embed"].T,
            targets.reshape(-1), vocab_chunks, tp_axis=tp)
        return torch.mean(losses)
    logits = forward(params, tokens, cfg, remat, tp_axis)
    return torch.mean(vocab_parallel_cross_entropy(
        logits, targets, axis_name=tp_axis, local=tp is None))


def train_step(params, opt_state, batch, cfg: GPT2Config, tx,
               remat: Union[bool, str] = True,
               vocab_chunks: Optional[int] = None,
               tp_axis: Optional[str] = "tp"):
    """One training step of :func:`loss_fn` (``_common.train_step``), as
    ``bench.py``'s GPT-2 step: ``(params, opt_state, loss)``, the params
    updated in place (this rank's shards with ``tp_axis`` bound, whose
    gradients need no reduction over tp)."""
    return _common.train_step(
        params, opt_state, tx,
        lambda live: loss_fn(live, batch, cfg, remat=remat,
                             vocab_chunks=vocab_chunks, tp_axis=tp_axis))
