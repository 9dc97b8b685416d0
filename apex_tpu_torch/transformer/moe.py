"""Mixture-of-Experts (port of ``apex_tpu/transformer/moe.py``).

The GShard/Switch formulation as the reference writes it, static-shaped
throughout:

- router: softmax over experts, top-1 (Switch) or top-k (GShard) gating
  with the load-balancing auxiliary loss and the optional router z-loss;
- dispatch/combine: one-hot ``[tokens, experts, capacity]`` masks, no
  sorting; tokens past an expert's capacity are dropped (the residual
  stream carries them unchanged);
- the dispatch, combine and expert contractions sum in fp32
  (``ops.precision.einsum_fp32acc``), as the reference pins them.

Expert parallelism: with a group bound to ``ep_axis`` (default
``"ep"``) the expert weights are this rank's ``E / ep`` experts
(:func:`moe_param_specs`), the router and the routing see all E, and the
dispatched ``[E, C, h]`` tokens cross the group twice by tiled
all-to-all (``distributed.backend.all_to_all``, differentiable):
``[E, C, h] -> [E/ep, ep*C, h]`` before the experts and back after.
With no group bound every expert runs here, the same math.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.ops.precision import einsum_fp32acc as _ein_fp32acc
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound

EXPERT_AXIS = "ep"


class MoEConfig(NamedTuple):
    hidden_size: int
    ffn_hidden_size: int
    num_experts: int
    top_k: int = 2                 # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    router_jitter: float = 0.0     # optional exploration noise (training)
    aux_loss_coef: float = 1e-2
    # router z-loss (ST-MoE §4, arXiv:2202.08906); 0 disables (default)
    z_loss_coef: float = 0.0


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    dtype: torch.dtype = torch.float32,
                    device: _device.DeviceLike = None):
    """router [h, E] + per-expert MLP weights stacked on dim 0
    (``moe.py:55``), drawn from ``generator`` on its device and placed
    on ``device`` (default: the GPU, raising when there is none): the
    same laws as the reference, not the same numbers."""
    device = _device.resolve(device)
    h, f, e = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_experts
    lim1 = (6.0 / (h + f)) ** 0.5
    dev = generator.device

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=dev)
        return (u * (2 * lim1) - lim1).to(dtype).to(device)

    router = torch.randn((h, e), generator=generator, dtype=torch.float32,
                         device=dev) * 0.02
    return {"router": router.to(dtype).to(device), "wi": uniform(e, h, f),
            "wo": uniform(e, f, h)}


def moe_param_specs(cfg: MoEConfig, ep_axis: str = EXPERT_AXIS):
    """The partition spec of each leaf of :func:`init_moe_params`'s tree
    (``moe.py:71``) in the port's tuple form: the stacked experts split
    over ``ep_axis`` on dim 0, the router replicated."""
    del cfg
    return {"router": (), "wi": (ep_axis, None, None),
            "wo": (ep_axis, None, None)}


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_gates(logits: torch.Tensor, cfg: MoEConfig,
                 with_stats: bool = False):
    """Top-k gating with position-in-expert assignment (GShard; the
    reference's ``router_gates``, ``moe.py:83``).

    logits [T, E] -> (combine [T, E, C] fp32, dispatch [T, E, C] bool,
    aux): tokens past an expert's capacity C get zero gates. ``aux`` is
    the scalar total auxiliary loss (load balance + optional z-loss).
    ``with_stats`` appends ``{"dropped_frac", "balance_loss", "z_loss"}``
    (dropped_frac: the share of the T*k assignments past capacity).
    Each choice takes the first maximum of the remaining probabilities
    (``torch.argmax``, as ``jnp.argmax``).
    """
    t, e = logits.shape
    c = _capacity(t, cfg)
    probs = torch.softmax(logits.float(), dim=-1)             # [T, E]

    remaining = probs
    # cumulative per-expert fill across the k choices
    fill = torch.zeros((e,), dtype=torch.float32, device=logits.device)
    gates_sum = torch.zeros((t,), dtype=torch.float32, device=logits.device)
    pieces = []
    for _ in range(cfg.top_k):
        idx = torch.argmax(remaining, dim=-1)                 # [T]
        onehot = _one_hot(idx, e)                             # [T, E]
        gate = torch.sum(probs * onehot, dim=-1)              # [T]
        # position of each token in its chosen expert's queue: earlier
        # tokens' choices (this k) plus the earlier choices' fill
        pos = (torch.cumsum(onehot, dim=0) - onehot) + fill[None, :]
        pos_t = torch.sum(pos * onehot, dim=-1).long()        # [T]
        keep = pos_t < c
        gate = gate * keep.float()
        pieces.append((onehot, gate, pos_t, keep))
        fill = fill + torch.sum(onehot, dim=0)
        gates_sum = gates_sum + gate
        remaining = remaining * (1.0 - onehot)

    # top-k > 1: the kept gates renormalised to sum to 1 a token (GShard /
    # Mixtral); top-1 keeps the raw probability (Switch eq. 2), or the
    # router would learn from the balance loss only
    if cfg.top_k == 1:
        denom = torch.ones_like(gates_sum)
    else:
        denom = torch.clamp(gates_sum, min=1e-9)
    combine = torch.zeros((t, e, c), dtype=torch.float32,
                          device=logits.device)
    for onehot, gate, pos_t, keep in pieces:
        slot = _one_hot(pos_t, c)                             # [T, C]
        contrib = ((gate / denom)[:, None, None] * onehot[:, :, None]
                   * slot[:, None, :])
        combine = combine + torch.where(keep[:, None, None], contrib,
                                        torch.zeros_like(contrib))
    dispatch = combine > 0.0

    # load-balancing aux loss (Switch eq. 4): E * mean_frac . mean_prob
    frac = torch.mean(pieces[0][0], dim=0)
    mean_prob = torch.mean(probs, dim=0)
    balance = cfg.aux_loss_coef * e * torch.sum(frac * mean_prob)
    # router z-loss (ST-MoE eq. 5): mean logsumexp(fp32 logits)^2, skipped
    # at the 0.0 default
    if cfg.z_loss_coef:
        z_loss = cfg.z_loss_coef * torch.mean(
            torch.logsumexp(logits.float(), dim=-1) ** 2)
    else:
        z_loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    aux = balance + z_loss
    if not with_stats:
        return combine, dispatch, aux
    kept = sum(torch.sum(keep.float()) for _, _, _, keep in pieces)
    stats = {"dropped_frac": 1.0 - kept / (t * cfg.top_k),
             "balance_loss": balance, "z_loss": z_loss}
    return combine, dispatch, aux, stats


def expert_parallel_apply(expert_fn, expert_params, x: torch.Tensor,
                          router: torch.Tensor, cfg: MoEConfig,
                          ep_axis: Optional[str] = EXPERT_AXIS,
                          router_key: Optional[torch.Generator] = None,
                          with_stats: bool = False):
    """Route tokens through per-expert functions; returns (y, aux)
    (``moe.py:168``), or (y, aux, stats) ``with_stats``.

    ``expert_fn(expert_params, tokens)`` maps [E_local, C', h] ->
    [E_local, C', h] with the stacked params of this rank's experts:
    with a group bound to ``ep_axis`` the tokens of every rank for this
    rank's E/ep experts (C' = ep * C), else all E experts on this
    rank's tokens. The stats are this rank's. ``router_key``, a
    ``torch.Generator``, draws the multiplicative router jitter when
    ``cfg.router_jitter`` > 0 (the law of the reference's, not its
    numbers), on the logits' device (``_device.generator_on``)."""
    lead = x.shape[:-1]
    h = x.shape[-1]
    xt = x.reshape(-1, h)

    logits = torch.matmul(xt.float(), router.float())
    if router_key is not None and cfg.router_jitter > 0.0:
        gen = _device.generator_on(router_key, logits.device)
        u = torch.rand(logits.shape, generator=gen, dtype=torch.float32,
                       device=logits.device)
        logits = logits * (u * (2 * cfg.router_jitter)
                           + (1.0 - cfg.router_jitter))
    gated = router_gates(logits, cfg, with_stats=with_stats)
    combine, dispatch, aux = gated[:3]

    expert_in = _ein_fp32acc("tec,th->ech", dispatch.to(xt.dtype), xt)
    ep = _axis_bound(ep_axis)
    if ep:
        # [E, C, h] -> [E/n, n*C, h]: expert chunk j to rank j, every
        # rank's C-token slab for this rank's experts along capacity
        expert_in = _backend.all_to_all(expert_in, ep_axis, split_axis=0,
                                        concat_axis=1)
    y = expert_fn(expert_params, expert_in)
    if ep:
        # back: capacity slab j to rank j, experts in global order
        y = _backend.all_to_all(y, ep_axis, split_axis=1, concat_axis=0)
    out = _ein_fp32acc("tec,ech->th", combine.to(xt.dtype), y)
    out = out.reshape(*lead, h).to(x.dtype)
    if with_stats:
        return out, aux.float(), gated[3]
    return out, aux.float()


def moe_mlp(params, x: torch.Tensor, cfg: MoEConfig,
            ep_axis: Optional[str] = EXPERT_AXIS,
            activation=lambda y: F.gelu(y, approximate="tanh"),
            router_key: Optional[torch.Generator] = None,
            with_stats: bool = False):
    """MoE feed-forward on [..., h]; returns (y, aux) (``moe.py:226``).
    ``params``: ``router`` [h, E], ``wi`` [E, h, f], ``wo`` [E, f, h]
    (with ``ep_axis`` bound, this rank's [E/ep, ...] experts).
    The default activation is ``jax.nn.gelu``'s default, the tanh
    approximation."""

    def expert_fn(p, tokens):
        y = _ein_fp32acc("ech,ehf->ecf", tokens, p["wi"].to(tokens.dtype))
        y = activation(y)
        return _ein_fp32acc("ecf,efh->ech", y, p["wo"].to(tokens.dtype))

    return expert_parallel_apply(
        expert_fn, {"wi": params["wi"], "wo": params["wo"]}, x,
        params["router"], cfg, ep_axis=ep_axis, router_key=router_key,
        with_stats=with_stats)
