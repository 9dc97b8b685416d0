"""Shared model-zoo helpers (port of ``apex_tpu/models/_common.py``): the
init law, the transformer pieces GPT-2 and BERT share, the per-layer
loop over stacked weights and the train step."""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch import _tree
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
)


def fan_in_normal(generator: torch.Generator, *shape, fan_in=None,
                  dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) init (fan_in defaults to the second-to-last dim),
    drawn in fp32 on the generator's device, then cast to ``dtype``."""
    scale = (fan_in if fan_in is not None else shape[-2]) ** -0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)


def layer_norm(x, w, b, eps):
    return fused_layer_norm_affine(x, w, b, (x.shape[-1],), eps=eps)


def packed_qkv_attention(x, lp, num_heads: int, head_dim: int,
                         softmax_fn: Callable):
    """Megatron packed-qkv attention of the gpt2/bert families
    (``_common.py:65``), single-device. ``lp`` carries wqkv [h, 3, h],
    bqkv [3, h], wo and bo; ``softmax_fn(scores, scale) -> probs`` is the
    mask flavour (causal for gpt2, padding for bert). The score and
    probs-times-v products are ``torch.einsum``, outside any kernel, as in
    the reference."""
    b, s, h = x.shape
    n, d = num_heads, head_dim
    qkv = column_parallel_linear(x, lp["wqkv"].reshape(h, -1),
                                 lp["bqkv"].reshape(-1))
    q, k, v = (t.reshape(b, s, n, d) for t in torch.chunk(qkv, 3, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = softmax_fn(scores, d ** -0.5).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, n * d)
    return row_parallel_linear(o, lp["wo"], lp["bo"])


def packed_mlp(x, lp, act_fn: Callable):
    """fc -> act -> proj (``_common.py:93``), single-device."""
    y = column_parallel_linear(x, lp["wfc"], lp["bfc"])
    return row_parallel_linear(act_fn(y), lp["wproj"], lp["bproj"])


def run_stacked(x, layers: Dict, num_layers: int, layer_fn: Callable,
                remat: Union[bool, str] = True):
    """``x = layer_fn(x, lp)`` for each row ``lp`` of the stacked
    ``[L, ...]`` weights (the reference's ``lax.scan``). ``remat``: False
    keeps every activation for the backward; True recomputes each layer
    in the backward (``torch.utils.checkpoint``, non-reentrant). The
    ``"dots"`` policy is not ported yet."""
    if remat not in (False, True):
        raise NotImplementedError(f"remat={remat!r}: only False and True "
                                  f"are ported")
    for idx in range(num_layers):
        lp = {name: w[idx] for name, w in layers.items()}
        if remat:
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
