"""Llama model family (port of ``apex_tpu/models/llama.py``).

Params are a dict of tensors in the reference's layout: per-layer weights
stacked on a leading ``[L, ...]`` dim, projections stored ``(in, out)``.
So :func:`params_from_numpy` takes the JAX package's params as numpy
arrays with no reshape. Projections, SwiGLU and the lm head are
``torch.matmul``, as the JAX package leaves them to XLA; RMSNorm and
attention go through the port's kernels, forward and backward.

Tensor and sequence parallelism: with a group bound to ``tp_axis``
(default ``"tp"``, :mod:`apex_tpu_torch.transformer.parallel_state`)
the params are this rank's shards (:func:`param_specs`: column kernels
split their output dim, row kernels their input dim, the embedding and
the head the vocab) and the layers run the reference's collectives:
each half-block enters its column products through one ``copy_to``
(or, under ``sequence_parallel``, one all-gather of the sequence) and
leaves the row product through an all-reduce (or a reduce-scatter of
the sequence); the embedding and the cross entropy are vocab-parallel.
Every rank's autograd gives the true gradients of its shards; what is
replicated over tp gets its true gradient on each rank, except the
norm scales under ``sequence_parallel``, which apply to this rank's
rows only and are summed over tp by the caller, as the reference's
train step does (``examples/llama_train.py:231-235``). :func:`stage_fn`
and :func:`split_stages` are the pipeline view. With no group bound the
code is the single-device path, unchanged.

Context parallelism: with a group bound to ``cp_axis`` the tokens are
this rank's shard of the sequence, the positions are global
(:func:`_positions`) and attention is
:func:`~apex_tpu_torch.transformer.context_parallel.ring_attention`; it
composes with tp (the ring runs on this rank's heads). Expert
parallelism: with a group bound to ``ep_axis`` the MoE layers hold this
rank's experts (:func:`param_specs`) and tokens reach them through the
two all-to-alls of ``moe.expert_parallel_apply``. As in the reference,
``cp_axis`` and ``ep_axis`` default to ``"cp"`` and ``"ep"``: a process
that binds either group gets that parallelism unless it passes None (a
group of one rank gives the unbound path's results bit for bit).

``num_experts > 0`` swaps the dense SwiGLU MLP for Mixtral-style top-k
routed SwiGLU experts (:mod:`apex_tpu_torch.transformer.moe`), whose
load-balancing aux loss :func:`forward_with_aux` and :func:`loss_fn`
return.

Two paths share the decoder layer: :func:`forward` (no grad) serves, and
:func:`loss_fn` / :func:`train_step` train, the counterpart of the JAX
package's ``value_and_grad(loss_fn)`` -> ``fused_adam(...).update`` ->
``params + updates`` step (``bench.py:388-395``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.models import _common
from apex_tpu_torch.models._common import fan_in_normal
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_rms_norm_affine,
)
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.precision import matmul_amp
from apex_tpu_torch.transformer import moe as _moe
from apex_tpu_torch.transformer.context_parallel import (
    context_parallel_positions,
    ring_attention,
)
from apex_tpu_torch.transformer.functional.chunked_ce import (
    chunked_lm_cross_entropy,
)
from apex_tpu_torch.transformer.functional.rope import apply_rotary_qk
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound


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
    # Mixtral-style MoE: 0 = dense SwiGLU; > 0 routes tokens through that
    # many SwiGLU experts (top-k, capacity-dropped)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

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
    torch and jax generators differ. An MoE config's expert weights
    ``[L, E, ...]`` are drawn a layer at a time, so the fp32 draw never
    holds more than one layer's experts."""
    device = _device.resolve(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dt = cfg.dtype

    def norm(*shape, fan_in=None):
        return fan_in_normal(generator, *shape, fan_in=fan_in,
                             dtype=dt).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def by_layer(*shape, fan_in):
        out = torch.empty((L, *shape), dtype=dt, device=device)
        for idx in range(L):
            out[idx] = norm(*shape, fan_in=fan_in)
        return out

    layers = {
        "attn_norm": ones(L, h),
        "wq": norm(L, h, nq * d),
        "wk": norm(L, h, nkv * d),
        "wv": norm(L, h, nkv * d),
        "wo": norm(L, nq * d, h),
        "mlp_norm": ones(L, h),
    }
    if cfg.moe:
        E = cfg.num_experts
        router = torch.randn((L, h, E), generator=generator,
                             dtype=torch.float32, device=generator.device)
        layers.update({
            "router": (router * 0.02).to(dt).to(device),
            "wg": by_layer(E, h, i, fan_in=h),
            "wu": by_layer(E, h, i, fan_in=h),
            "wd": by_layer(E, i, h, fan_in=i),
        })
    else:
        layers.update({
            "wg": norm(L, h, i),
            "wu": norm(L, h, i),
            "wd": norm(L, i, h),
        })
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


def matmul(x, w, scale=None):
    """The layers' default product, ``mm(x, w, scale)``: a plain matmul
    in the activation dtype (the serving scheduler's fp8 ``mm`` uses the
    per-layer weight ``scale``; this one has none)."""
    del scale
    return torch.matmul(x, w.to(x.dtype))


def _qkv(x, lp, cfg: LlamaConfig, positions, mm=matmul, sc=None):
    """Projections + rope on [b, s, h] -> q [b, s, nq, d], k / v
    [b, s, nkv, d]; ``positions`` [b, s] gives each row's own angles.
    ``mm(x, w, scale)`` is the product, ``sc`` the layer's weight scales
    by name."""
    b, s, _ = x.shape
    d = cfg.head_dim
    sc = sc or {}
    # the heads this rank holds: all of them, or a tp shard's
    q = mm(x, lp["wq"], sc.get("wq")).reshape(b, s, -1, d)
    k = mm(x, lp["wk"], sc.get("wk")).reshape(b, s, -1, d)
    v = mm(x, lp["wv"], sc.get("wv")).reshape(b, s, -1, d)
    q, k = apply_rotary_qk(q, k, positions=positions, base=cfg.rope_theta)
    return q, k, v


def causal_attention(q, k, v):
    """Self-attention of a whole sequence: the flash-forward kernel."""
    return flash_attention(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)


def _identity(h):
    return h


def _dense_ffn(h, lp, mm=matmul, sc=None, enter=_identity, row=None):
    """The dense SwiGLU MLP through ``mm(x, w, scale)``; ``enter`` and
    ``row`` as in :func:`decoder_layer`."""
    sc = sc or {}
    h = enter(h)
    g = mm(h, lp["wg"], sc.get("wg"))
    u = mm(h, lp["wu"], sc.get("wu"))
    return (row or mm)(F.silu(g) * u, lp["wd"], sc.get("wd"))


def decoder_layer(x, lp, cfg: LlamaConfig, positions, attend, mm=matmul,
                  sc=None, ffn=None, enter=_identity, row=None):
    """One pre-norm block on a single layer's params ``lp``.

    ``attend(q, k, v) -> o [b, s, nq, d]`` is the attention:
    :func:`causal_attention` for a whole sequence, a cache read for
    decode. Its 7 products go through ``mm(x, w, scale)`` with the
    layer's weight scales ``sc`` (the serving scheduler's ``_make_mm``;
    default :func:`matmul`). ``ffn(h, lp) -> y`` is the MLP half on the
    normed stream (default the dense SwiGLU through ``mm``; the MoE
    paths pass their routed experts). ``enter(h)`` takes each half's
    normed stream to its column products and ``row(y, w, scale)`` is the
    product that leaves the half (default ``mm``): the identity and
    ``mm`` on one device, the tensor-parallel regions on a rank's shards
    (:func:`_tp_hooks`). Returns ``(x, k, v)`` with this layer's rotated
    k / v."""
    sc = sc or {}
    x, h, k, v = _attention_half(x, lp, cfg, positions, attend, mm, sc,
                                 enter, row)
    y = (ffn(h, lp) if ffn is not None
         else _dense_ffn(h, lp, mm, sc, enter, row))
    return x + y, k, v


def _attention_half(x, lp, cfg: LlamaConfig, positions, attend, mm=matmul,
                    sc=None, enter=_identity, row=None):
    """The block up to its MLP: ``(x, h, k, v)``, x the residual stream
    after attention and h its MLP-normed copy."""
    sc = sc or {}
    h = enter(_rmsnorm(x, lp["attn_norm"], cfg.rms_eps))
    b, s = h.shape[:2]
    q, k, v = _qkv(h, lp, cfg, positions, mm, sc)
    o = attend(q, k, v).reshape(b, s, -1)
    x = x + (row or mm)(o, lp["wo"], sc.get("wo"))
    return x, _rmsnorm(x, lp["mlp_norm"], cfg.rms_eps), k, v


def _moe_cfg(cfg: LlamaConfig) -> _moe.MoEConfig:
    return _moe.MoEConfig(hidden_size=cfg.hidden_size,
                          ffn_hidden_size=cfg.intermediate_size,
                          num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                          capacity_factor=cfg.moe_capacity_factor)


def _moe_mlp(x, lp, cfg: LlamaConfig, ep_axis: Optional[str] = "ep"):
    """Mixtral-style routed SwiGLU experts in place of the dense MLP
    (``llama.py:231``): the training router (capacity drops, balance
    aux). With ``ep_axis`` bound ``lp`` holds this rank's experts and
    the tokens reach them by all-to-all; else every expert is here.
    Returns (y, aux)."""

    def expert_fn(p, tokens):  # [E_local, C', h] -> [E_local, C', h]
        g = torch.einsum("ech,ehf->ecf", tokens, p["wg"].to(tokens.dtype))
        u = torch.einsum("ech,ehf->ecf", tokens, p["wu"].to(tokens.dtype))
        return torch.einsum("ecf,efh->ech", F.silu(g) * u,
                            p["wd"].to(tokens.dtype))

    return _moe.expert_parallel_apply(
        expert_fn, {"wg": lp["wg"], "wu": lp["wu"], "wd": lp["wd"]}, x,
        lp["router"], _moe_cfg(cfg), ep_axis=ep_axis)


def _attend(cp_axis):
    """The training attention: the ring over ``cp_axis`` when it is
    bound (``llama.py:196-198``), else :func:`causal_attention`."""
    if not _axis_bound(cp_axis):
        return causal_attention

    def ring(q, k, v):
        return ring_attention(q, k, v, axis_name=cp_axis, causal=True)
    return ring


def _positions(b: int, s_local: int, cp_axis, device) -> torch.Tensor:
    """[b, s_local] position ids (``llama.py:288``): global ones of this
    rank's shard with ``cp_axis`` bound."""
    if _axis_bound(cp_axis):
        pos = context_parallel_positions(s_local, cp_axis, device=device)
    else:
        pos = torch.arange(s_local, device=device)
    return pos.expand(b, s_local)


def _check_heads(cfg: LlamaConfig, tp_axis) -> None:
    tp = _backend.get_world_size(tp_axis) if _axis_bound(tp_axis) else 1
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads}")


def _tp_hooks(tp_axis, sequence_parallel):
    """:func:`decoder_layer`'s ``enter`` and ``row`` on this rank's
    shards (``llama.py:270``, ``:205``). ``enter`` is the all-gather of
    the sequence under sequence parallelism (its backward a
    reduce-scatter), else ``copy_to`` (its backward an all-reduce), so
    the replicated input gets the sum of the ranks' partial cotangents.
    ``row`` is the row-parallel product: all-reduced, or
    reduce-scattered over the sequence under sequence parallelism."""
    def enter(h):
        if sequence_parallel:
            return mappings.gather_from_sequence_parallel_region(
                h, tp_axis, seq_dim=1)
        return mappings.copy_to_tensor_model_parallel_region(h, tp_axis)

    def row(y, w, scale=None):
        del scale
        return row_parallel_linear(
            y, w, input_is_parallel=True,
            sequence_parallel_enabled=sequence_parallel, axis_name=tp_axis,
            seq_dim=1)

    return enter, row


def decoder_layer_with_aux(x, lp, cfg: LlamaConfig, positions, *,
                           tp_axis: Optional[str] = "tp",
                           sequence_parallel: bool = False,
                           cp_axis: Optional[str] = "cp",
                           ep_axis: Optional[str] = "ep"):
    """The training block (``llama.py:257``, the reference's
    ``decoder_layer``): :func:`decoder_layer` with
    :func:`causal_attention`, and the MoE MLP when ``cfg.moe``. Returns
    ``(x, aux)``, aux the layer's MoE aux loss (fp32, 0 when dense).
    With ``tp_axis`` bound, ``lp`` holds this rank's shards and ``x`` is
    sequence-split under sequence parallelism; the MoE MLP then runs
    this rank's experts on every tp rank (routing is the same on each),
    and its input keeps this rank's slice of a cotangent every rank
    holds whole. ``cp_axis`` bound: ring attention over this rank's
    sequence shard; ``ep_axis`` bound: ``lp`` holds this rank's
    experts."""
    attend = _attend(cp_axis)
    hooks = {}
    moe_in = moe_out = _identity
    if _axis_bound(tp_axis):
        _check_heads(cfg, tp_axis)
        hooks = dict(zip(("enter", "row"),
                         _tp_hooks(tp_axis, sequence_parallel)))
        if sequence_parallel:
            def moe_in(h):
                return mappings.gather_from_sequence_parallel_region(
                    h, tp_axis, seq_dim=1, tensor_parallel_output_grad=False)

            def moe_out(y):
                return mappings.scatter_to_sequence_parallel_region(
                    y, tp_axis, seq_dim=1)
    if not cfg.moe:
        x = decoder_layer(x, lp, cfg, positions, attend, **hooks)[0]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    x, h, _, _ = _attention_half(x, lp, cfg, positions, attend, **hooks)
    y, aux = _moe_mlp(moe_in(h), lp, cfg, ep_axis)
    return x + moe_out(y), aux


def embed(params, tokens, cfg: LlamaConfig, tp_axis: Optional[str] = "tp",
          sequence_parallel: bool = False):
    """Token embeddings [b, s, h] in ``cfg.dtype`` (``llama.py:331``):
    vocab-parallel with ``tp_axis`` bound, then split over the sequence
    under sequence parallelism."""
    if not _axis_bound(tp_axis):
        return F.embedding(tokens, params["embed"]).to(cfg.dtype)
    x = vocab_parallel_embedding(tokens, params["embed"],
                                 tp_axis).to(cfg.dtype)
    if sequence_parallel:
        x = mappings.scatter_to_sequence_parallel_region(x, tp_axis,
                                                         seq_dim=1)
    return x


def lm_head_weight(params, cfg: LlamaConfig):
    """The [h, vocab] classifier kernel (embed.T when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head(params, x, cfg: LlamaConfig, tp_axis: Optional[str] = "tp",
            sequence_parallel: bool = False):
    """Final norm + logits [b, s, vocab] (``llama.py:345``): a matmul in
    the activation dtype through the amp hook, site ``"lm_head"`` (an
    fp8 product under the O4 context when registered), then fp32. With
    ``tp_axis`` bound the logits are this rank's vocab slice
    [b, s, vocab/tp]; under sequence parallelism ``x`` is all-gathered
    first."""
    tp = _axis_bound(tp_axis)
    if tp and sequence_parallel:
        x = mappings.gather_from_sequence_parallel_region(x, tp_axis,
                                                          seq_dim=1)
    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps)
    if tp and not sequence_parallel:
        x = mappings.copy_to_tensor_model_parallel_region(x, tp_axis)
    w = lm_head_weight(params, cfg)
    return matmul_amp(x, w.to(x.dtype), name="lm_head").float()


def _num_layers(layers: Dict) -> int:
    return next(iter(layers.values())).shape[0]


def run_layers(x, layers: Dict, cfg: LlamaConfig, positions,
               remat: Union[bool, str] = True, *,
               tp_axis: Optional[str] = "tp",
               sequence_parallel: bool = False,
               cp_axis: Optional[str] = "cp",
               ep_axis: Optional[str] = "ep"):
    """Run the stacked ``[L, ...]`` layer weights over the residual
    stream ``x`` [b, s, h] (``run_layers``, ``llama.py:296``; L is the
    weights' leading dim, a pipeline stage's share under pp). Returns
    ``(x, aux)``, aux the per-layer MoE aux losses summed (0 when dense).
    ``remat`` as in :func:`_common.run_stacked`."""
    kw = dict(tp_axis=tp_axis, sequence_parallel=sequence_parallel,
              cp_axis=cp_axis, ep_axis=ep_axis)

    def body(carry, lp):
        h, aux = carry
        h, a = decoder_layer_with_aux(h, lp, cfg, positions, **kw)
        return h, aux + a

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _common.run_stacked((x, zero), layers, _num_layers(layers), body,
                               remat)


def hidden_states(params, tokens, cfg: LlamaConfig,
                  remat: Union[bool, str] = True, *,
                  tp_axis: Optional[str] = "tp",
                  sequence_parallel: bool = False,
                  cp_axis: Optional[str] = "cp",
                  ep_axis: Optional[str] = "ep"):
    """The shared trunk: embed + all decoder layers (pre-final-norm).
    tokens [b, s] -> (hidden [b, s, h], MoE aux loss) (``llama.py:363``);
    under sequence parallelism hidden is this rank's [b, s/tp, h]; with
    ``cp_axis`` bound ``tokens`` are this rank's sequence shard."""
    b, s = tokens.shape
    positions = _positions(b, s, cp_axis, tokens.device)
    x = embed(params, tokens, cfg, tp_axis, sequence_parallel)
    return run_layers(x, params["layers"], cfg, positions, remat,
                      tp_axis=tp_axis, sequence_parallel=sequence_parallel,
                      cp_axis=cp_axis, ep_axis=ep_axis)


def forward_with_aux(params, tokens, cfg: LlamaConfig,
                     remat: Union[bool, str] = True, *,
                     tp_axis: Optional[str] = "tp",
                     sequence_parallel: bool = False,
                     cp_axis: Optional[str] = "cp",
                     ep_axis: Optional[str] = "ep"):
    """tokens [b, s] -> (logits [b, s, vocab] fp32, MoE aux loss)
    (``llama.py:379``), differentiable; vocab-split with ``tp_axis``
    bound."""
    x, aux = hidden_states(params, tokens, cfg, remat, tp_axis=tp_axis,
                           sequence_parallel=sequence_parallel,
                           cp_axis=cp_axis, ep_axis=ep_axis)
    return lm_head(params, x, cfg, tp_axis, sequence_parallel), aux


@torch.no_grad()
def forward(params, tokens, cfg: LlamaConfig, *,
            tp_axis: Optional[str] = "tp", sequence_parallel: bool = False,
            cp_axis: Optional[str] = "cp", ep_axis: Optional[str] = "ep"):
    """tokens [b, s] -> logits [b, s, vocab] (fp32), with no autograd
    graph: the serving path's forward. :func:`loss_fn` is the
    differentiable one."""
    return forward_with_aux(params, tokens, cfg, remat=False,
                            tp_axis=tp_axis,
                            sequence_parallel=sequence_parallel,
                            cp_axis=cp_axis, ep_axis=ep_axis)[0]


def loss_fn(params, batch, cfg: LlamaConfig,
            remat: Union[bool, str] = True,
            vocab_chunks: Optional[int] = None, *,
            tp_axis: Optional[str] = "tp", sequence_parallel: bool = False,
            cp_axis: Optional[str] = "cp",
            ep_axis: Optional[str] = "ep") -> torch.Tensor:
    """Mean next-token CE plus the MoE aux loss (0 when dense);
    ``batch = (tokens, targets)``, both [b, s] (``llama.py:399``).

    ``vocab_chunks``: stream the lm head and the CE in that many vocab
    slices (:func:`chunked_lm_cross_entropy`), so the fp32
    ``[b*s, vocab]`` logits never exist (``llama.py:412``); with
    ``tp_axis`` bound the per-rank streams merge vocab-parallel, and the
    final norm runs on this rank's rows before the sequence is gathered
    (row by row the same values), so its scale's gradient is tp-partial
    under sequence parallelism, as the decoder norms' are."""
    tokens, targets = batch
    kw = dict(tp_axis=tp_axis, sequence_parallel=sequence_parallel,
              cp_axis=cp_axis, ep_axis=ep_axis)
    if vocab_chunks:
        x, aux = hidden_states(params, tokens, cfg, remat, **kw)
        x = _rmsnorm(x, params["final_norm"], cfg.rms_eps)
        tp = _axis_bound(tp_axis)
        if tp and sequence_parallel:
            # the chunked CE all-reduces d_hidden: every rank holds it whole
            x = mappings.gather_from_sequence_parallel_region(
                x, tp_axis, seq_dim=1, tensor_parallel_output_grad=False)
        losses = chunked_lm_cross_entropy(
            x.reshape(-1, x.shape[-1]), lm_head_weight(params, cfg),
            targets.reshape(-1), vocab_chunks,
            tp_axis=tp_axis if tp else None)
        return torch.mean(losses) + aux
    logits, aux = forward_with_aux(params, tokens, cfg, remat, **kw)
    return torch.mean(vocab_parallel_cross_entropy(
        logits, targets, axis_name=tp_axis,
        local=not _axis_bound(tp_axis))) + aux


def train_step(params, opt_state, batch, cfg: LlamaConfig, tx,
               remat: Union[bool, str] = False,
               vocab_chunks: Optional[int] = None, *,
               tp_axis: Optional[str] = "tp",
               sequence_parallel: bool = False,
               cp_axis: Optional[str] = "cp",
               ep_axis: Optional[str] = "ep"):
    """One training step of :func:`loss_fn` (``_common.train_step``):
    ``(params, opt_state, loss)``, the params updated in place. As in
    :func:`loss_fn`, a group bound to ``tp_axis`` makes ``params`` this
    rank's shards; ``tp_axis=None`` keeps the single-device path in a
    process whose tp group is bound. The update applies this rank's own
    gradients: a caller that splits the tokens over cp or ep reduces
    them first (``examples/long_context.py``, ``examples/moe_train.py``);
    with every such group of one rank it is the single-device step."""
    return _common.train_step(
        params, opt_state, tx,
        lambda live: loss_fn(live, batch, cfg, remat=remat,
                             vocab_chunks=vocab_chunks, tp_axis=tp_axis,
                             sequence_parallel=sequence_parallel,
                             cp_axis=cp_axis, ep_axis=ep_axis))


def param_specs(cfg: LlamaConfig, tp_axis: str = "tp",
                ep_axis: str = "ep") -> Dict:
    """The partition spec of each leaf of :func:`init_params`'s tree
    (``llama.py:425``), in the port's form: a tuple with one entry a dim,
    the axis a dim is split over or None. Column kernels split the
    output dim, row kernels the input dim, the embedding and the head
    the vocab dim; norms replicate (``()``)."""
    t = tp_axis
    layer_specs = {
        "attn_norm": (), "mlp_norm": (),
        "wq": (None, None, t), "wk": (None, None, t),
        "wv": (None, None, t), "wo": (None, t, None),
    }
    if cfg.moe:
        # experts split over ep_axis (orthogonal to tp); router replicates
        e = ep_axis
        layer_specs.update({
            "router": (),
            "wg": (None, e, None, None),
            "wu": (None, e, None, None),
            "wd": (None, e, None, None),
        })
    else:
        layer_specs.update({
            "wg": (None, None, t), "wu": (None, None, t),
            "wd": (None, t, None),
        })
    specs = {"embed": (t, None), "layers": layer_specs, "final_norm": ()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, t)
    return specs


# ------------------------------------------------------------- pipeline view


def stage_fn(stage_params, x, cfg: LlamaConfig, positions,
             tp_axis: Optional[str] = "tp", cp_axis: Optional[str] = None,
             sequence_parallel: bool = False,
             ep_axis: Optional[str] = "ep"):
    """One pipeline stage's stacked layer slice applied to the residual
    stream (``llama.py:463``), for ``pipeline_parallel.schedules``; the
    embedding and the head live outside (:func:`embed`, :func:`lm_head`
    on the first and last stage). The MoE aux loss is dropped: the
    pipeline carries activations only."""
    x, _ = run_layers(x, stage_params, cfg, positions, remat=False,
                      tp_axis=tp_axis, sequence_parallel=sequence_parallel,
                      cp_axis=cp_axis, ep_axis=ep_axis)
    return x


def split_stages(params, n_stages: int) -> Dict:
    """The stacked ``[L, ...]`` layers as ``[n_stages, L / n_stages, ...]``
    views (``llama.py:481``): stage ``r`` is row ``r``."""
    def r(x):
        return x.reshape(n_stages, x.shape[0] // n_stages, *x.shape[1:])

    return {k: r(v) for k, v in params["layers"].items()}
