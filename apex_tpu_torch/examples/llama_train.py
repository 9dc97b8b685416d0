"""Llama training under tensor x pipeline x data parallelism with
sequence parallelism (port of ``examples/llama_train.py``'s step,
``:124-245``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 8 --backend gloo \\
        --cpu apex_tpu_torch/examples/llama_train.py --pp 2 --dp 2 --tp 2

One process a rank (the launcher starts ``torch.distributed``);
:func:`parallel_state.initialize_model_parallel` splits the world into
the reference's ``(pp, dp, tp)`` grid, tp fastest. Each rank holds its
shards (:func:`shard`). A train step:

1. embeds its dp slice of the batch (vocab-parallel, split over the
   sequence under sequence parallelism) on the first stage;
2. runs ``pipelined_forward`` over ``llama.stage_fn`` with per-stage
   recompute, as the reference does;
3. takes the lm head and ``vocab_parallel_cross_entropy`` per
   microbatch on the last stage, the loss summed over pp;
4. reduces the gradients as the reference does (``:228-235``): the dp
   mean of every leaf, the pp sum of the io leaves (embedding, final
   norm, head), the tp sum of the norm scales under sequence
   parallelism. Each rank's autograd gives local gradients, so these
   reductions give the gradient of the global batch's mean loss;
5. updates its shards with ``fused_adam``.

Not ported here (ROADMAP.md, Queue 1 item 5): ``--auto-shard``,
``--opt-level O4``, the checkpoint and resilience flags and the
observability tiers.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.examples._common import apply_updates, coords_of, shard
from apex_tpu_torch.models import llama
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    _last_stage_mean_loss,
    pipelined_forward,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)

AXES = ("pp", "dp", "tp")
IO_KEYS = ("embed", "final_norm", "lm_head")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pp", type=int, default=2)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--microbatch-size", type=int, default=2)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--layers-per-stage", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no-sequence-parallel", action="store_true")
    p.add_argument("--fixed-data", action="store_true",
                   help="overfit one fixed batch (deterministic decrease)")
    p.add_argument("--flat", action="store_true",
                   help="fused_adam(flat=True): one Adam launch a step")
    return p.parse_args(argv)


def tiny_config(pp: int, tp: int, layers_per_stage: int = 2,
                seq: int = 32) -> llama.LlamaConfig:
    """The reference example's model, scaled with tp (``:129-132``)."""
    return llama.tiny(
        num_layers=layers_per_stage * pp, num_heads=2 * tp,
        num_kv_heads=tp, hidden_size=32 * tp, intermediate_size=64 * tp,
        vocab_size=128 * tp, max_seq_len=seq)


def stage_specs(cfg: llama.LlamaConfig) -> Dict:
    """Each layer leaf's spec with the leading stage dim split over pp."""
    return {k: ("pp",) + v
            for k, v in llama.param_specs(cfg)["layers"].items()}


def io_specs(cfg: llama.LlamaConfig) -> Dict:
    return {k: v for k, v in llama.param_specs(cfg).items()
            if k != "layers"}


def _coords() -> Dict[str, tuple]:
    """axis -> (this rank's index, the axis's size)."""
    return coords_of(AXES)


def shard_params(params, cfg: llama.LlamaConfig, coords=None):
    """``(stage, io)``: this rank's stage layers ``[L / pp, ...]`` and io
    leaves, cut from the full params (the reference's ``shard_map``
    in_specs)."""
    coords = coords or _coords()
    pp = coords["pp"][1]
    stages = llama.split_stages(params, pp)
    sspec = stage_specs(cfg)
    stage = {k: shard(v, sspec[k], coords)[0] for k, v in stages.items()}
    ispec = io_specs(cfg)
    io = {k: shard(params[k], ispec[k], coords) for k in ispec}
    return stage, io


class Megatron3D:
    """The reference example's train step over this rank's shards.

    ``cfg``: the model; ``tx``: the optimizer (``fused_adam``);
    ``microbatches`` x ``microbatch_size`` sequences of ``seq`` tokens a
    dp rank a step; ``sequence_parallel``. The grid comes from
    ``parallel_state`` (``initialize_model_parallel``)."""

    def __init__(self, cfg: llama.LlamaConfig, tx, microbatches: int,
                 microbatch_size: int, seq: int,
                 sequence_parallel: bool = True):
        self.cfg, self.tx = cfg, tx
        self.M, self.mb, self.s = microbatches, microbatch_size, seq
        self.coords = _coords()
        self.sp = sequence_parallel and self.coords["tp"][1] > 1
        if seq % self.coords["tp"][1]:
            raise ValueError(f"seq {seq} must split over tp "
                             f"{self.coords['tp'][1]}")

    def local_batch(self, tokens: torch.Tensor) -> torch.Tensor:
        """This dp rank's ``[M, mb, s]`` of the global ``[M, mb * dp, s]``
        (the reference's ``P(None, 'dp', None)``)."""
        r, _ = self.coords["dp"]
        return tokens[:, r * self.mb:(r + 1) * self.mb]

    def loss(self, stage, io, tokens, targets):
        """The loss (the mean over this dp rank's microbatches, summed
        over pp), differentiable w.r.t. ``stage`` and ``io``; ``tokens``
        and ``targets`` are this rank's ``[M, mb, s]``."""
        cfg, sp = self.cfg, self.sp
        M, mb, s = self.M, self.mb, self.s
        s_local = s // self.coords["tp"][1] if sp else s
        if self.coords["pp"][0] == 0:
            x = llama.embed(io, tokens.reshape(M * mb, s), cfg, "tp", sp)
            x_mb = x.reshape(M, mb, s_local, cfg.hidden_size)
        else:  # only the first stage reads the pipeline's inputs
            x_mb = torch.zeros((M, mb, s_local, cfg.hidden_size),
                               dtype=cfg.dtype, device=tokens.device)
        positions = torch.arange(s, device=tokens.device).expand(mb, s)

        def stage_fn(sp_params, h):
            return llama.stage_fn(sp_params, h, cfg, positions,
                                  tp_axis="tp", cp_axis=None,
                                  sequence_parallel=sp)

        outs = pipelined_forward(stage_fn, stage, x_mb, axis_name="pp",
                                 remat=True)

        def mb_loss(o, t):
            logits = llama.lm_head(io, o, cfg, tp_axis="tp",
                                   sequence_parallel=sp)
            return torch.mean(vocab_parallel_cross_entropy(
                logits, t, axis_name="tp"))

        return _last_stage_mean_loss(mb_loss, outs, targets, "pp")

    def grads(self, stage, io, tokens, targets):
        """``(loss, stage_grads, io_grads)`` with the reference's
        reductions (``:228-235``) applied: the gradients of the global
        batch's mean loss w.r.t. this rank's shards, and the loss
        averaged over dp."""
        live = {"stage": _tree.map_leaves(
            lambda p: p.detach().requires_grad_(), stage),
            "io": _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                   io)}
        loss = self.loss(live["stage"], live["io"], tokens, targets)
        leaves = _tree.leaves(live)
        # the first stage holds no loss, the others no embedding lookup:
        # their grads are zeros, as the reference's masked ones are
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _tree.unflatten(_tree.paths(live), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        del live
        g_stage, g_io = grads["stage"], grads["io"]
        dp = self.coords["dp"][1]
        if dp > 1:
            g_stage = {k: _backend.all_reduce(v, _backend.ReduceOp.AVG, "dp")
                       for k, v in g_stage.items()}
        g_io = {k: _backend.all_reduce(v, _backend.ReduceOp.SUM, "pp")
                for k, v in g_io.items()}
        if dp > 1:
            g_io = {k: _backend.all_reduce(v, _backend.ReduceOp.AVG, "dp")
                    for k, v in g_io.items()}
        if self.sp:  # sequence-parallel norm scales saw this rank's rows
            g_stage = {k: (_backend.all_reduce(v, _backend.ReduceOp.SUM,
                                               "tp")
                           if k.endswith("norm") else v)
                       for k, v in g_stage.items()}
            g_io = {k: (_backend.all_reduce(v, _backend.ReduceOp.SUM, "tp")
                        if k == "final_norm" else v)
                    for k, v in g_io.items()}
        loss = loss.detach()
        if dp > 1:
            loss = _backend.all_reduce(loss, _backend.ReduceOp.AVG, "dp")
        return loss, g_stage, g_io

    def apply(self, stage, io, opt_state, g_stage, g_io):
        """``tx`` on every shard, in place; the new optimizer state."""
        return apply_updates(self.tx, {"stage": stage, "io": io}, opt_state,
                             {"stage": g_stage, "io": g_io})

    def train_step(self, stage, io, opt_state, tokens, targets):
        """One step on this rank's ``[M, mb, s]`` tokens: ``(loss,
        opt_state)``, the shards updated in place."""
        loss, g_stage, g_io = self.grads(stage, io, tokens, targets)
        opt_state = self.apply(stage, io, opt_state, g_stage, g_io)
        return loss, opt_state


def make_batch(step: int, cfg: llama.LlamaConfig, M: int, rows: int,
               seq: int, fixed: bool = False, device=None):
    """The global ``[M, rows, seq]`` tokens of a step and their next-token
    targets, the same on every rank (a pure function of the step, as the
    reference's ``fold_in`` stream is)."""
    gen = torch.Generator().manual_seed(1 if fixed else 1 + step)
    tokens = torch.randint(0, cfg.vocab_size, (M, rows, seq), generator=gen)
    tokens = tokens.to(device)
    return tokens, torch.roll(tokens, -1, dims=-1)


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if world != args.pp * args.dp * args.tp:
        raise SystemExit(f"{world} ranks for pp {args.pp} x dp {args.dp} x "
                         f"tp {args.tp}")
    ps.initialize_model_parallel(args.tp, args.pp)
    cfg = tiny_config(args.pp, args.tp, args.layers_per_stage, args.seq)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device=device)
    stage, io = shard_params(params, cfg)
    del params
    M, mb, s = args.microbatches, args.microbatch_size, args.seq
    step3d = Megatron3D(cfg, fused_adam(lr=args.lr, flat=args.flat), M, mb, s,
                        sequence_parallel=not args.no_sequence_parallel)
    opt_state = step3d.tx.init({"stage": stage, "io": io})
    first = last = None
    for it in range(args.steps):
        tokens, targets = make_batch(it, cfg, M, mb * args.dp, s,
                                     args.fixed_data, device)
        t0 = time.perf_counter()
        loss, opt_state = step3d.train_step(
            stage, io, opt_state, step3d.local_batch(tokens),
            step3d.local_batch(targets))
        loss = float(loss)
        dt = time.perf_counter() - t0
        first = loss if first is None else first
        last = loss
        if rank == 0:
            print(f"step {it:3d}  loss {loss:.4f}  ({dt * 1e3:.0f} ms  "
                  f"{M * mb * args.dp * s / dt:.0f} tok/s)", flush=True)
    if rank == 0 and first is not None:
        print(f"mesh pp={args.pp} dp={args.dp} tp={args.tp} sp={step3d.sp}: "
              f"loss {first:.4f} -> {last:.4f} "
              f"({'decreased' if last < first else 'NOT decreased'})",
              flush=True)
    ps.destroy_model_parallel()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
