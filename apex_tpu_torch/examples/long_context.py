"""Long-context Llama training with ring-attention context parallelism
(port of ``examples/long_context.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 8 --backend gloo \\
        --cpu apex_tpu_torch/examples/long_context.py --cp 4 --dp 2 \\
        --seq 512 --steps 10

One process a rank (the launcher starts ``torch.distributed``);
:func:`parallel_state.initialize_model_parallel` splits the world into
the reference's ``(dp, cp)`` grid, cp fastest. Each rank holds
``batch / dp`` sequences of ``seq / cp`` tokens, and attention runs as a
ring of flash calls over the cp group
(:func:`~apex_tpu_torch.transformer.context_parallel.ring_attention`).
A train step (:class:`ContextParallelStep`):

1. the loss of this rank's tokens (``llama.loss_fn`` with ``cp_axis``
   bound), differentiated by this rank's autograd: the ring's backward
   sends each K/V block's gradient home, so a rank's gradients hold its
   queries' share of every rank's loss;
2. the gradients averaged over cp, then dp: the gradient of the global
   batch's mean loss (every rank holds as many tokens), which the
   reference reaches with its ``pmean``s (``:94-103``);
3. ``fused_adam`` on the replicated params.

Before training, the sharded loss at init must equal the single-device
loss of the whole batch within 5e-3 (``:103-110``); at the end the loss
must have fallen.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.examples._common import apply_updates, coords_of
from apex_tpu_torch.models import llama
from apex_tpu_torch.transformer import parallel_state as ps

PARITY_TOL = 5e-3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cp", type=int, default=4)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--seq", type=int, default=512,
                   help="GLOBAL sequence length (seq/cp per rank)")
    p.add_argument("--batch", type=int, default=4,
                   help="global batch (batch/dp per dp rank)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    return p.parse_args(argv)


class ContextParallelStep:
    """The reference example's step on this rank's ``[b/dp, s/cp]``
    tokens. ``cfg``: the model; ``tx``: the optimizer; ``remat`` and
    ``vocab_chunks`` as ``llama.loss_fn`` takes them. The grid comes
    from ``parallel_state``."""

    def __init__(self, cfg: llama.LlamaConfig, tx, remat=True,
                 vocab_chunks: Optional[int] = None):
        self.cfg, self.tx = cfg, tx
        self.remat, self.vocab_chunks = remat, vocab_chunks
        self.coords = coords_of(("dp", "cp"))

    def local_batch(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``[b, s]`` tokens (the
        reference's ``P('dp', 'cp')``)."""
        (d, dp), (c, cp) = self.coords["dp"], self.coords["cp"]
        b, s = tokens.shape
        if b % dp or s % cp:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not split "
                             f"over dp {dp} x cp {cp}")
        rows, cols = b // dp, s // cp
        return tokens[d * rows:(d + 1) * rows, c * cols:(c + 1) * cols]

    def loss(self, params, tokens, targets) -> torch.Tensor:
        """The mean loss of this rank's tokens, differentiable."""
        return llama.loss_fn(params, (tokens, targets), self.cfg,
                             remat=self.remat,
                             vocab_chunks=self.vocab_chunks, tp_axis=None,
                             cp_axis="cp")

    def grads(self, params, tokens, targets):
        """``(loss, grads)``: the global batch's mean loss and its
        gradients, from this rank's ``[b/dp, s/cp]`` tokens."""
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                params)
        loss = self.loss(live, tokens, targets)
        grads = list(torch.autograd.grad(loss, _tree.leaves(live)))
        del live
        avg = _backend.ReduceOp.AVG
        for i, g in enumerate(grads):  # leaf by leaf: one copy at a time
            grads[i] = _backend.all_reduce(_backend.all_reduce(g, avg, "cp"),
                                           avg, "dp")
            del g
        loss = _backend.all_reduce(_backend.all_reduce(loss.detach(), avg,
                                                       "cp"), avg, "dp")
        return loss, _tree.unflatten(_tree.paths(params), grads)

    def apply(self, params, opt_state, grads):
        """``tx`` on the params, in place; the new optimizer state."""
        return apply_updates(self.tx, params, opt_state, grads)

    def train_step(self, params, opt_state, tokens, targets):
        """One step on this rank's tokens: ``(loss, opt_state)``, the
        params updated in place."""
        loss, grads = self.grads(params, tokens, targets)
        return loss, self.apply(params, opt_state, grads)


def make_batch(cfg: llama.LlamaConfig, batch: int, seq: int,
               device=None):
    """One fixed global ``[batch, seq]`` batch and its next-token
    targets (the reference overfits one batch), the same on every
    rank."""
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=gen).to(device)
    return tokens, torch.roll(tokens, -1, dims=-1)


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if world != args.cp * args.dp:
        raise SystemExit(f"{world} ranks for cp {args.cp} x dp {args.dp}")
    if args.seq % args.cp:
        raise SystemExit(f"--seq {args.seq} must divide by --cp {args.cp}")
    if args.batch % args.dp:
        raise SystemExit(f"--batch {args.batch} must divide by --dp "
                         f"{args.dp}")
    ps.initialize_model_parallel(context_parallel_size_=args.cp)
    cfg = llama.tiny(max_seq_len=args.seq)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device=device)
    step = ContextParallelStep(cfg, fused_adam(lr=args.lr))
    opt_state = step.tx.init(params)
    tokens, targets = make_batch(cfg, args.batch, args.seq, device)
    # ground truth: the sharded global loss at init equals the
    # single-device loss of the whole batch
    with torch.no_grad():
        ref = float(llama.loss_fn(params, (tokens, targets), cfg,
                                  tp_axis=None, cp_axis=None))
    local = (step.local_batch(tokens), step.local_batch(targets))
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss, opt_state = step.train_step(params, opt_state, *local)
        losses.append(float(loss))
        if i == 0:
            if abs(losses[0] - ref) > PARITY_TOL * max(1.0, abs(ref)):
                raise SystemExit(f"cp-sharded loss {losses[0]:.5f} != "
                                 f"single-device loss {ref:.5f}")
            if rank == 0:
                print(f"parity: sharded loss {losses[0]:.5f} == "
                      f"single-device {ref:.5f} OK", flush=True)
        if rank == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)",
                  flush=True)
    verdict = "decreased" if losses[-1] < losses[0] else "NOT decreased"
    if rank == 0:
        print(f"ring-attention cp={args.cp} dp={args.dp} seq={args.seq}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({verdict})",
              flush=True)
    ps.destroy_model_parallel()
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
