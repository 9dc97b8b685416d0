"""GPT-2 tensor-parallel training, the "GPT-2 345M apex.transformer
tensor-parallel + fused softmax" configuration of ``BASELINE.json``
(port of ``examples/gpt2_train.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 8 --backend gloo \\
        --cpu apex_tpu_torch/examples/gpt2_train.py --dp 2 --tp 4 \\
        --steps 10 [--checkpoint-dir DIR --save-every 5 [--resume]]

One process a rank; :func:`parallel_state.initialize_model_parallel`
splits the world into the reference's ``(dp, tp)`` grid, tp fastest.
Each rank holds its shards (``gpt2.param_specs``) and ``batch`` of the
global batch's sequences. A train step (:class:`TensorParallelGPT2Step`):

1. ``gpt2.loss_fn`` with ``tp_axis`` bound on this rank's sequences:
   the layers' column/row collectives, the vocab-parallel embedding and
   cross entropy; each rank's autograd gives the true gradients of its
   shards and of the replicated leaves;
2. the gradients averaged over dp: the gradient of the global batch's
   mean loss (the reference's ``pmean`` over dp, ``:76-79``; the
   replicated leaves need no tp reduction here);
3. ``fused_adam`` on this rank's shards.

The first step's loss must equal the single-device loss of the global
batch (within 1e-4 relative), and the loss must fall. With
``--checkpoint-dir`` each rank saves its shards, Adam state and step to
``DIR/rank<r>`` through ``CheckpointManager`` every ``--save-every``
steps and at the last; ``--resume`` restarts from each rank's latest
step (the reference saves one global checkpoint of the sharded arrays;
here every rank writes its own).
"""

from __future__ import annotations

import argparse
import os
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
from apex_tpu_torch.models import gpt2
from apex_tpu_torch.transformer import parallel_state as ps

PARITY_TOL = 1e-4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--tp", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4, help="per-dp-rank batch")
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-dir", default="",
                   help="save train state here every --save-every steps")
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step in --checkpoint-dir")
    return p.parse_args(argv)


def tiny_config(tp: int, layers: int = 2, seq: int = 32) -> gpt2.GPT2Config:
    """The reference example's model, scaled with tp (``:54-56``)."""
    return gpt2.tiny(num_layers=layers, num_heads=2 * tp,
                     hidden_size=32 * tp, vocab_size=128 * tp,
                     max_seq_len=seq)


def shard_params(params, cfg: gpt2.GPT2Config):
    """This rank's shards of the full params (the reference's
    ``shard_map`` in_specs)."""
    return shard_tree(params, gpt2.param_specs(cfg), coords_of(("tp",)))


class TensorParallelGPT2Step:
    """The reference example's step over this rank's shards and its dp
    slice of the batch; ``remat`` and ``vocab_chunks`` as
    ``gpt2.loss_fn`` takes them."""

    def __init__(self, cfg: gpt2.GPT2Config, tx, remat=True,
                 vocab_chunks: Optional[int] = None):
        self.cfg, self.tx = cfg, tx
        self.remat, self.vocab_chunks = remat, vocab_chunks
        self.coords = coords_of(("dp", "tp"))

    def local_batch(self, tokens: torch.Tensor) -> torch.Tensor:
        """This dp rank's rows of the global ``[B, s]`` (``P('dp')``)."""
        r, dp = self.coords["dp"]
        rows = tokens.shape[0] // dp
        return tokens[r * rows:(r + 1) * rows]

    def grads(self, params, tokens, targets):
        """``(loss, grads)``: the global batch's mean loss and the
        gradients of it w.r.t. this rank's shards."""
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                params)
        loss = gpt2.loss_fn(live, (tokens, targets), self.cfg,
                            remat=self.remat, vocab_chunks=self.vocab_chunks,
                            tp_axis="tp")
        grads = list(torch.autograd.grad(loss, _tree.leaves(live)))
        del live
        loss = loss.detach()
        if self.coords["dp"][1] > 1:
            avg = _backend.ReduceOp.AVG
            grads = [_backend.all_reduce(g, avg, "dp") for g in grads]
            loss = _backend.all_reduce(loss, avg, "dp")
        return loss, _tree.unflatten(_tree.paths(params), grads)

    def apply(self, params, opt_state, grads):
        """``tx`` on every shard, in place; the new optimizer state."""
        return apply_updates(self.tx, params, opt_state, grads)

    def train_step(self, params, opt_state, tokens, targets):
        loss, grads = self.grads(params, tokens, targets)
        return loss, self.apply(params, opt_state, grads)


def make_batch(step: int, cfg: gpt2.GPT2Config, rows: int, seq: int,
               device=None):
    """The global ``[rows, seq]`` tokens of a step and their next-token
    targets, the same on every rank (a pure function of the step, so a
    resumed run sees the batches the uninterrupted one did)."""
    gen = torch.Generator().manual_seed(1 + step)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq),
                           generator=gen).to(device)
    return tokens, torch.roll(tokens, -1, dims=-1)


def checkpoint_manager(directory: str, rank: int):
    """This rank's ``CheckpointManager`` under ``directory``."""
    from apex_tpu_torch.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(directory, f"rank{rank}"),
                             max_to_keep=2)


def train_state(params, opt_state, it: int):
    return {"params": params, "opt": opt_state,
            "it": torch.tensor(it, dtype=torch.int32)}


def resume(manager, params, opt_state, device):
    """``(params, opt_state, start_it)`` from the manager's latest step;
    ``start_it`` None when there is none."""
    if manager.latest_step() is None:
        return params, opt_state, None
    st = manager.restore(train_state(params, opt_state, 0), device=device)
    return st["params"], st["opt"], int(st["it"]) + 1


def run(step: TensorParallelGPT2Step, params, opt_state, steps: int,
        batch: int, seq: int, device, start_it: int = 0, manager=None,
        save_every: int = 5, log=None):
    """Steps ``start_it .. steps - 1`` on this rank, saving through
    ``manager`` at each ``save_every``-th step and the last; returns
    ``(params, opt_state, losses)``."""
    dp = step.coords["dp"][1]
    losses = []
    for it in range(start_it, steps):
        tokens, targets = make_batch(it, step.cfg, batch * dp, seq, device)
        t0 = time.perf_counter()
        loss, opt_state = step.train_step(params, opt_state,
                                          step.local_batch(tokens),
                                          step.local_batch(targets))
        losses.append(float(loss))
        if log is not None:
            log(f"step {it:3d}  loss {losses[-1]:.4f}  "
                f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if manager is not None and (it % save_every == 0
                                    or it == steps - 1):
            manager.save(it, train_state(params, opt_state, it))
    return params, opt_state, losses


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if world != args.dp * args.tp:
        raise SystemExit(f"{world} ranks for dp {args.dp} x tp {args.tp}")
    ps.initialize_model_parallel(args.tp)
    cfg = tiny_config(args.tp, args.layers, args.seq)
    full = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                            device=device)
    params = shard_params(full, cfg)
    step = TensorParallelGPT2Step(cfg, fused_adam(lr=args.lr))
    opt_state = step.tx.init(params)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    manager = start_it = None
    if args.checkpoint_dir:
        manager = checkpoint_manager(args.checkpoint_dir, rank)
        if args.resume:
            params, opt_state, start_it = resume(manager, params, opt_state,
                                                 device)
            if start_it is not None:
                log(f"=> resumed from step {start_it - 1}")
                if start_it >= args.steps:
                    log(f"nothing to do: resumed step + 1 ({start_it}) >= "
                        f"--steps {args.steps}")
                    ps.destroy_model_parallel()
                    return 0
    if start_it is None:
        # ground truth: the sharded loss of the first batch equals the
        # single-device loss of the global batch
        tokens, targets = make_batch(0, cfg, args.batch * args.dp, args.seq,
                                     device)
        with torch.no_grad():
            ref = float(gpt2.loss_fn(full, (tokens, targets), cfg,
                                     remat=False, tp_axis=None))
            got = gpt2.loss_fn(params, (step.local_batch(tokens),
                                        step.local_batch(targets)), cfg,
                               remat=False, tp_axis="tp")
            if args.dp > 1:
                got = _backend.all_reduce(got, _backend.ReduceOp.AVG, "dp")
        got = float(got)
        if abs(got - ref) > PARITY_TOL * max(1.0, abs(ref)):
            raise SystemExit(f"tp-sharded loss {got:.6f} != single-device "
                             f"loss {ref:.6f}")
        log(f"parity: sharded loss {got:.6f} == single-device {ref:.6f} OK")
    del full
    params, opt_state, losses = run(
        step, params, opt_state, args.steps, args.batch, args.seq, device,
        start_it or 0, manager, args.save_every, log)
    ok = len(losses) < 2 or losses[-1] < losses[0]
    if losses:
        log(f"mesh dp={args.dp} tp={args.tp}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} ({'decreased' if ok else 'NOT decreased'})")
    ps.destroy_model_parallel()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
