"""Mixture-of-Experts training over a dp x ep grid: expert parallelism
through the tiled all-to-all (port of ``examples/moe_train.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 8 --backend gloo \\
        --cpu apex_tpu_torch/examples/moe_train.py --dp 2 --ep 4 --steps 10

One process a rank; :func:`bind_ep_grid` makes the ``(dp, ep)`` grid,
ep fastest. Tokens are
split over both axes (ep doubles as data parallelism for the tokens);
the expert weights over ep only (:func:`moe.moe_param_specs`), the
router is replicated. A train step (:class:`ExpertParallelStep`):

1. the MSE of this rank's tokens plus the router's aux loss through
   ``moe_mlp`` with ``ep_axis`` bound, differentiated by this rank's
   autograd: the all-to-all's backward returns each expert output's
   gradient to the rank that holds the expert, so a rank's expert
   gradients hold every ep rank's tokens;
2. the reductions that make them the gradient of the global mean loss
   (:func:`reduce_ep_grads`): the router's averaged over ep and dp, the
   experts' averaged over dp and divided by ep (their sum over the ep
   group is already in them);
3. ``fused_adam`` on this rank's params.

The first step's loss must equal the mean over the ranks' token shards
of ``moe_mlp`` with every expert on one device (the same routing, each
shard its own capacity), and at the end the MSE must have fallen.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.examples._common import (
    apply_updates,
    coords_of,
    shard_tree,
)
from apex_tpu_torch.transformer import moe

PARITY_TOL = 1e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--ep", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=16, help="tokens per rank")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--experts-per-rank", type=int, default=2)
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    return p.parse_args(argv)


def bind_ep_grid(dp: int, ep: int) -> None:
    """The reference's ``Mesh(reshape(dp, ep), ("dp", "ep"))``: rank
    ``d * ep + e``; ``"ep"`` bound to the ranks of its row, ``"dp"`` to
    those of its column. Every rank makes every group."""
    import torch.distributed as dist

    for d in range(dp):
        _backend.new_group(moe.EXPERT_AXIS,
                           ranks=[d * ep + e for e in range(ep)])
    for e in range(ep):
        _backend.new_group("dp", ranks=[d * ep + e for d in range(dp)])
    if dist.get_world_size() != dp * ep:
        raise SystemExit(f"{dist.get_world_size()} ranks for dp {dp} x "
                         f"ep {ep}")


def reduce_ep_grads(grads, specs, ep: int):
    """This rank's gradients (a tree) made the gradient of the global
    mean loss: a leaf split over ep (its ``specs`` entry names
    ``"ep"``) holds the sum over the ep group already (the all-to-all's
    backward brought every rank's share home), so it is averaged over dp
    and divided by ``ep``; a replicated leaf is averaged over ep and
    dp."""
    avg = _backend.ReduceOp.AVG

    def spec_of(path):
        node = specs
        for part in path:
            node = node[part]
        return node

    paths = _tree.paths(grads)
    out = _tree.leaves(grads)
    del grads
    for i, path in enumerate(paths):  # leaf by leaf: one copy at a time
        g = out[i]
        if moe.EXPERT_AXIS in spec_of(path):
            out[i] = _backend.divide(_backend.all_reduce(g, avg, "dp"), ep)
        else:
            out[i] = _backend.all_reduce(_backend.all_reduce(
                g, avg, moe.EXPERT_AXIS), avg, "dp")
        del g
    return _tree.unflatten(paths, out)


class ExpertParallelStep:
    """The reference example's step on this rank's tokens with its
    experts. The grid comes from :func:`bind_ep_grid`."""

    def __init__(self, cfg: moe.MoEConfig, tx):
        self.cfg, self.tx = cfg, tx
        self.coords = coords_of(("dp", moe.EXPERT_AXIS))

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global ``[B, ...]`` (the reference's
        ``P(('dp', 'ep'))``: dp-major blocks)."""
        (d, dp), (e, ep) = self.coords["dp"], self.coords[moe.EXPERT_AXIS]
        rows = x.shape[0] // (dp * ep)
        r = d * ep + e
        return x[r * rows:(r + 1) * rows]

    def loss(self, params, x, target):
        """``(loss, mse)`` of this rank's tokens, differentiable."""
        y, aux = moe.moe_mlp(params, x, self.cfg, ep_axis=moe.EXPERT_AXIS)
        mse = torch.mean((y - target) ** 2)
        return mse + aux, mse

    def grads(self, params, x, target):
        """``(mse, grads)``: the global mean MSE and the gradients of the
        global mean loss w.r.t. this rank's params."""
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                params)
        loss, mse = self.loss(live, x, target)
        grads = dict(zip(live, torch.autograd.grad(loss,
                                                   list(live.values()))))
        del live
        grads = reduce_ep_grads(grads, moe.moe_param_specs(self.cfg),
                                self.coords[moe.EXPERT_AXIS][1])
        avg = _backend.ReduceOp.AVG
        mse = _backend.all_reduce(_backend.all_reduce(
            mse.detach(), avg, moe.EXPERT_AXIS), avg, "dp")
        return mse, grads

    def apply(self, params, opt_state, grads):
        return apply_updates(self.tx, params, opt_state, grads)

    def train_step(self, params, opt_state, x, target):
        mse, grads = self.grads(params, x, target)
        return mse, self.apply(params, opt_state, grads)


def make_batch(step: int, rows: int, hidden: int, device=None):
    """The global ``[rows, hidden]`` inputs of a step and their targets
    ``sin(3x)``, the same on every rank."""
    gen = torch.Generator().manual_seed(1 + step)
    x = torch.randn((rows, hidden), generator=gen).to(device)
    return x, torch.sin(3.0 * x)


def single_device_loss(params, x, target, cfg, n_shards: int) -> float:
    """The mean over ``n_shards`` row blocks of ``moe_mlp``'s loss with
    every expert here: what the sharded step's loss must equal."""
    total = 0.0
    with torch.no_grad():
        for xs, ts in zip(x.chunk(n_shards), target.chunk(n_shards)):
            y, aux = moe.moe_mlp(params, xs, cfg, ep_axis=None)
            total += float(torch.mean((y - ts) ** 2) + aux)
    return total / n_shards


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if world != args.dp * args.ep:
        raise SystemExit(f"{world} ranks for dp {args.dp} x ep {args.ep}")
    bind_ep_grid(args.dp, args.ep)
    cfg = moe.MoEConfig(hidden_size=args.hidden,
                        ffn_hidden_size=2 * args.hidden,
                        num_experts=args.experts_per_rank * args.ep,
                        top_k=args.top_k, capacity_factor=2.0)
    full = moe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                               device=device)
    step = ExpertParallelStep(cfg, fused_adam(lr=args.lr))
    params = shard_tree(full, moe.moe_param_specs(cfg), step.coords)
    opt_state = step.tx.init(params)
    B = args.batch * world
    first = mse = None
    for it in range(args.steps):
        x, target = make_batch(it, B, cfg.hidden_size, device)
        t0 = time.perf_counter()
        if it == 0:
            live = {k: v.detach() for k, v in params.items()}
            with torch.no_grad():
                loss0 = step.loss(live, step.local_batch(x),
                                  step.local_batch(target))[0]
            avg = _backend.ReduceOp.AVG
            loss0 = float(_backend.all_reduce(_backend.all_reduce(
                loss0, avg, moe.EXPERT_AXIS), avg, "dp"))
            ref = single_device_loss(full, x, target, cfg, world)
            del full
            if abs(loss0 - ref) > PARITY_TOL * max(1.0, abs(ref)):
                raise SystemExit(f"ep-sharded loss {loss0:.6f} != "
                                 f"single-device loss {ref:.6f}")
            if rank == 0:
                print(f"parity: sharded loss {loss0:.6f} == single-device "
                      f"{ref:.6f} OK", flush=True)
        mse, opt_state = step.train_step(params, opt_state,
                                         step.local_batch(x),
                                         step.local_batch(target))
        mse = float(mse)
        first = mse if first is None else first
        if rank == 0:
            print(f"step {it:3d}  mse {mse:.4f}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)", flush=True)
    if rank == 0:
        print(f"mesh dp={args.dp} ep={args.ep} experts={cfg.num_experts} "
              f"top{cfg.top_k}: mse {first:.4f} -> {mse:.4f} "
              f"({'decreased' if mse < first else 'NOT decreased'})",
              flush=True)
    _backend.unbind(moe.EXPERT_AXIS)
    return 0 if mse < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
