"""Shared model-zoo helpers (port of ``apex_tpu/models/_common.py``): the
init law, the BatchNorm switch, the transformer pieces GPT-2 and BERT
share, the per-layer loop over stacked weights and the train step."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
)
from apex_tpu_torch.ops.precision import matmul_amp
from apex_tpu_torch.parallel import sync_batchnorm
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound


def fan_in_normal(generator: torch.Generator, *shape, fan_in=None,
                  dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) init (fan_in defaults to the second-to-last dim),
    drawn in fp32 on the generator's device, then cast to ``dtype``."""
    scale = (fan_in if fan_in is not None else shape[-2]) ** -0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """Plain BatchNorm or cross-rank SyncBatchNorm (``_common.py:20``),
    functional over the params and running stats a model's tree holds
    for it: ``{"scale", "bias"}`` and ``{"mean", "var"}`` under the key
    :attr:`inner`, as flax nests them.

    ``momentum`` is the fraction of a running stat KEPT each step (flax's
    convention). The two branches differ as the reference's do:

    - plain (flax ``nn.BatchNorm``): mean and the BIASED variance of the
      batch, ``E[x^2] - E[x]^2`` in fp32 clipped at 0 (flax's fast
      variance), the running stats moved by ``momentum``;
    - ``sync``: :func:`~apex_tpu_torch.parallel.sync_batchnorm.
      sync_batch_norm` over the group bound to ``axis_name`` (None, or
      ``torch.distributed`` not started: this rank's batch), Chan's merge,
      momentum ``1 - momentum`` (torch's convention, the fraction
      replaced) and the UNBIASED running variance.

    Statistics are fp32; the output has ``x``'s dtype."""

    sync: bool = False
    axis_name: Optional[str] = "data"
    momentum: float = 0.9
    eps: float = 1e-5
    # sync only: groups of this many consecutive ranks share statistics
    group_size: Optional[int] = None

    @property
    def inner(self) -> str:
        """The key of the normalisation's own params and stats."""
        return "SyncBatchNorm_0" if self.sync else "BatchNorm_0"

    def init(self, features: int, device) -> tuple:
        """``(params, batch_stats)`` of a fresh layer, fp32, nested under
        :attr:`inner`: scale 1, bias 0, mean 0, var 1 (flax's inits)."""
        def full(value):
            return torch.full((features,), value, dtype=torch.float32,
                              device=device)

        return ({self.inner: {"scale": full(1.0), "bias": full(0.0)}},
                {self.inner: {"mean": full(0.0), "var": full(1.0)}})

    def __call__(self, params, stats, x, train: bool, ch: int = -1):
        """``(y, new_stats)``: ``params`` and ``stats`` this layer's
        (keyed by :attr:`inner`), ``ch`` the channel dim of ``x``.
        ``new_stats`` holds new tensors in training, ``stats`` itself
        otherwise."""
        p, s = params[self.inner], stats[self.inner]
        if self.sync:
            y, mean, var = sync_batchnorm.sync_batch_norm(
                x, p["scale"], p["bias"], s["mean"], s["var"], train,
                momentum=1.0 - self.momentum, eps=self.eps, ch=ch,
                group=self.axis_name, group_size=self.group_size)
            return y, ({self.inner: {"mean": mean, "var": var}}
                       if train else stats)
        ch = ch % x.dim()
        if not train:
            return sync_batchnorm.normalize_running(
                x, p["scale"], p["bias"], s["mean"], s["var"], self.eps,
                ch), stats
        dims = [i for i in range(x.dim()) if i != ch]
        with torch.no_grad():
            x32 = x.float()
            mean = x32.mean(dims)
            var = torch.clamp(torch.square(x32).mean(dims)
                              - torch.square(mean), min=0.0)
            del x32
            count = torch.tensor(float(x.numel() // x.shape[ch]),
                                 device=x.device)
            m = self.momentum
            new = {"mean": m * s["mean"] + (1 - m) * mean,
                   "var": m * s["var"] + (1 - m) * var}
        y = sync_batchnorm.normalize(x, p["scale"], p["bias"], mean, var,
                                     count, self.eps, ch)
        return y, {self.inner: new}


def layer_norm(x, w, b, eps):
    return fused_layer_norm_affine(x, w, b, (x.shape[-1],), eps=eps)


def bound_tp(tp_axis: Optional[str]) -> Optional[str]:
    """``tp_axis`` when a group is bound to it, else None: the one test
    of whether the gpt2/bert layers run tensor-parallel."""
    return tp_axis if _axis_bound(tp_axis) else None


def tp_size(tp_axis: Optional[str]) -> int:
    """Ranks in the group bound to ``tp_axis``; 1 when none is
    (``_common.py:59``)."""
    tp = bound_tp(tp_axis)
    return _backend.get_world_size(tp) if tp is not None else 1


def _linear(x, w, b):
    """The single-device product plus bias: what the column- and
    row-parallel linears compute with no group bound (the amp site
    ``"tp_linear"``, as theirs)."""
    return matmul_amp(x, w, name="tp_linear") + b


def _column(x, w, b, tp):
    if tp is None:
        return _linear(x, w, b)
    return column_parallel_linear(x, w, b, gather_output=False,
                                  axis_name=tp)


def _row(x, w, b, tp):
    if tp is None:
        return _linear(x, w, b)
    return row_parallel_linear(x, w, b, input_is_parallel=True,
                               axis_name=tp)


def packed_qkv_attention(x, lp, num_heads: int, head_dim: int,
                         softmax_fn: Callable,
                         tp_axis: Optional[str] = None):
    """Megatron packed-qkv attention of the gpt2/bert families
    (``_common.py:65``). ``lp`` carries wqkv [h, 3, h], bqkv [3, h], wo
    and bo; ``softmax_fn(scores, scale) -> probs`` is the mask flavour
    (causal for gpt2, padding for bert). With a group bound to
    ``tp_axis`` ``lp`` is this rank's shard: wqkv split on its last dim,
    so the rank holds its heads of each of q, k and v ([h, 3, h/tp], a
    thirds split of the local product is exact), wo on its input dim.
    The score and probs-times-v products are ``torch.einsum``, outside
    any kernel, as in the reference."""
    b, s, h = x.shape
    tp = bound_tp(tp_axis)
    n, d = num_heads // tp_size(tp), head_dim
    qkv = _column(x, lp["wqkv"].reshape(h, -1), lp["bqkv"].reshape(-1), tp)
    q, k, v = (t.reshape(b, s, n, d) for t in torch.chunk(qkv, 3, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = softmax_fn(scores, d ** -0.5).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, n * d)
    return _row(o, lp["wo"], lp["bo"], tp)


def packed_mlp(x, lp, act_fn: Callable, tp_axis: Optional[str] = None):
    """fc -> act -> proj (``_common.py:93``), column- then row-parallel
    with a group bound to ``tp_axis``."""
    tp = bound_tp(tp_axis)
    y = _column(x, lp["wfc"], lp["bfc"], tp)
    return _row(act_fn(y), lp["wproj"], lp["bproj"], tp)


def token_embedding(tokens, table, tp_axis: Optional[str] = None):
    """The rows of ``table`` for ``tokens``: vocab-parallel (this rank's
    rows, summed over tp) with a group bound to ``tp_axis``."""
    tp = bound_tp(tp_axis)
    if tp is None:
        return torch.nn.functional.embedding(tokens, table)
    return vocab_parallel_embedding(tokens, table, tp)


def tied_logits(x, embed, tp_axis: Optional[str] = None):
    """fp32 logits of the tied head ``x @ embed.T``: this rank's vocab
    slice with a group bound to ``tp_axis``, whose input gradient is
    then all-reduced (``copy_to``), as every rank's slice reads the
    whole of ``x``."""
    tp = bound_tp(tp_axis)
    if tp is not None:
        x = mappings.copy_to_tensor_model_parallel_region(x, tp)
    return torch.matmul(x, embed.T.to(x.dtype)).float()


#: the products whose outputs ``remat="dots"`` keeps: matmuls with no
#: batch dimension (a ``[b, s, h] @ [h, n]`` ``torch.matmul`` lowers to
#: ``mm``); ``bmm`` has one and is recomputed, as JAX's policy does
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of products with no batch dimension, recompute the rest
    (the kernels too: a ctypes launch is no aten op, as a
    ``pallas_call`` is no dot)."""
    del ctx, args, kwargs
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def run_stacked(x, layers: Dict, num_layers: int, layer_fn: Callable,
                remat: Union[bool, str] = True):
    """``x = layer_fn(x, lp)`` for each row ``lp`` of the stacked
    ``[L, ...]`` weights (the reference's ``lax.scan``; ``x`` is the
    carry, a tensor or a tuple of them). ``remat``: False keeps every
    activation for the backward; True recomputes each layer in the
    backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"``
    recomputes each layer but keeps its ``mm``/``addmm`` outputs
    (:func:`_dots_policy`, a selective checkpoint)."""
    if remat not in (False, True, "dots"):
        raise ValueError(f"remat must be False, True or 'dots', got "
                         f"{remat!r}")
    for idx in range(num_layers):
        lp = {name: w[idx] for name, w in layers.items()}
        if remat == "dots":
            x = checkpoint(layer_fn, x, lp, use_reentrant=False,
                           context_fn=_dots_contexts)
        elif remat:
            x = checkpoint(layer_fn, x, lp, use_reentrant=False)
        else:
            x = layer_fn(x, lp)
    return x


def train_step(params, opt_state, tx, loss_of: Callable):
    """One training step: the loss ``loss_of(params)`` and its grads,
    then ``tx.update``, then params + updates. Returns
    ``(params, opt_state, loss)``.

    Unlike the JAX step, the params are updated IN PLACE
    (``p.add_(delta)`` in each param's dtype, as JAX's
    ``tree_map(jnp.add, params, updates)`` adds in the param dtype), and
    the same dict is returned; ``loss`` is a 0-dim tensor on the params'
    device."""
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(live)
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    grads = _tree.unflatten(_tree.paths(params), list(grads))
    del live
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        del grads
        for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
            p.add_(u)
    return params, opt_state, loss.detach()
