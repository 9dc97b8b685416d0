"""BERT MLM pretraining with FusedLAMB + FusedLayerNorm over dp ranks, the
"BERT-base FusedLAMB + FusedLayerNorm" configuration of ``BASELINE.json``
(port of ``examples/bert_train.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 --backend gloo \\
        [--cpu] apex_tpu_torch/examples/bert_train.py --dp 2 --steps 10 \\
        [--checkpoint-dir DIR --save-every 5 [--resume]]

One process a rank, every rank holding the whole params (LAMB's trust
ratios and its clipping norm are norms over whole tensors, so the
reference runs it on replicated params with dp-mean'd gradients). A
step (:func:`train_step`) takes this rank's ``batch`` of the global
batch's sequences and:

1. the MLM loss of this rank's rows weighted by its share of the global
   batch's masked positions (``n_r * dp / N``), so that the mean over
   the ranks is the global batch's loss, not the mean of the ranks'
   means (with 15% masking the counts differ by rank; the reference's
   grads also carry a factor dp, ROADMAP.md Queue 3);
2. this rank's autograd, then the gradients' and the loss's mean over
   ``"dp"``: the global batch's gradient, equal to one device's
   autograd of ``bert.loss_fn`` over all the rows;
3. ``fused_lamb`` on the replicated params.

LayerNorm forward and backward run the port's kernels (rows 6 and 7 of
PERF.md's table), and the masked softmax (row 11) when a padding mask is
given, as ``chip_smoke.py`` gives one. With ``--checkpoint-dir`` rank 0
saves the params, LAMB state and step through ``CheckpointManager`` every
``--save-every`` steps and at the last; ``--resume`` restarts every
rank from the latest one.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.examples._common import apply_updates
from apex_tpu_torch.models import bert

MASK_ID = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dp", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4, help="per-dp-rank batch")
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--checkpoint-dir", default="",
                   help="save train state here every --save-every steps")
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step in --checkpoint-dir")
    return p.parse_args(argv)


def tiny_config(layers: int = 2, seq: int = 32) -> bert.BertConfig:
    """The reference example's model (``:57``)."""
    return bert.tiny(num_layers=layers, num_heads=4, hidden_size=64,
                     vocab_size=256, max_seq_len=seq)


def make_batch(it: int, cfg: bert.BertConfig, rows: int, seq: int,
               mask_prob: float = 0.15, device=None):
    """The global ``(tokens, targets, loss_mask)`` of step ``it``, the
    same on every rank (a pure function of the step, so a resumed run
    sees the batches the uninterrupted one did): tokens drawn in [4,
    vocab), ``mask_prob`` of them replaced by ``MASK_ID``, the loss over
    those."""
    gen = torch.Generator().manual_seed(1 + it)
    clean = torch.randint(4, cfg.vocab_size, (rows, seq), generator=gen)
    mask = torch.rand((rows, seq), generator=gen) < mask_prob
    tokens = torch.where(mask, MASK_ID, clean)
    return tokens.to(device), clean.to(device), mask.float().to(device)


def rank_rows(t: torch.Tensor, axis_name: str = "dp") -> torch.Tensor:
    """This rank's rows of a global ``[B, ...]`` batch."""
    r, n = _backend.get_rank(axis_name), _backend.get_world_size(axis_name)
    rows = t.shape[0] // n
    return t[r * rows:(r + 1) * rows]


def grads(params, batch, cfg: bert.BertConfig, axis_name: str = "dp",
          pad_mask=None, remat=True):
    """``(loss, grads)``: the global batch's MLM loss and its gradients,
    from this rank's rows ``batch`` (and ``pad_mask``) and the mean over
    ``axis_name``; a tree like ``params``. ``remat`` as
    ``bert.loss_fn`` takes it (its default, as the reference example
    runs it)."""
    tokens, targets, loss_mask = batch
    n = _backend.get_world_size(axis_name)
    mine = torch.clamp(loss_mask.sum(), min=1.0)
    total = _backend.all_reduce(loss_mask.sum(), group=axis_name)
    share = (mine * n / torch.clamp(total, min=1.0)).detach()
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = bert.loss_fn(live, batch, cfg, pad_mask=pad_mask, remat=remat,
                        tp_axis=None) * share
    g = torch.autograd.grad(loss, _tree.leaves(live))
    del live
    avg = _backend.ReduceOp.AVG
    g = [_backend.all_reduce(x, avg, axis_name) for x in g]
    loss = _backend.all_reduce(loss.detach(), avg, axis_name)
    return loss, _tree.unflatten(_tree.paths(params), g)


def train_step(params, opt_state, batch, cfg: bert.BertConfig, tx,
               axis_name: str = "dp", pad_mask=None, remat=True):
    """One data-parallel step (:func:`grads`, then ``tx`` in place):
    ``(loss, opt_state)``."""
    loss, g = grads(params, batch, cfg, axis_name, pad_mask, remat)
    return loss, apply_updates(tx, params, opt_state, g)


def train_state(params, opt_state, it: int):
    return {"params": params, "opt": opt_state,
            "it": torch.tensor(it, dtype=torch.int32)}


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.checkpoint import CheckpointManager
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if world != args.dp:
        raise SystemExit(f"{world} ranks for dp {args.dp}")
    cfg = tiny_config(args.layers, args.seq)
    params = bert.init_params(torch.Generator().manual_seed(0), cfg,
                              device=device)
    tx = fused_lamb(lr=args.lr)
    opt_state = tx.init(params)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    manager, start_it = None, 0
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir, max_to_keep=2)
        if args.resume and manager.latest_step() is not None:
            st = manager.restore(train_state(params, opt_state, 0))
            params, opt_state = st["params"], st["opt"]
            start_it = int(st["it"]) + 1
            log(f"=> resumed from step {start_it - 1}")
            if start_it >= args.steps:
                log(f"nothing to do: resumed step + 1 ({start_it}) >= "
                    f"--steps {args.steps}")
                return 0
    first = loss = None
    for it in range(start_it, args.steps):
        batch = make_batch(it, cfg, args.batch * args.dp, args.seq,
                           args.mask_prob, device)
        t0 = time.perf_counter()
        loss, opt_state = train_step(params, opt_state,
                                     tuple(rank_rows(t) for t in batch),
                                     cfg, tx)
        loss = float(loss)
        first = loss if first is None else first
        log(f"step {it:3d}  mlm loss {loss:.4f}  "
            f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if manager is not None and rank == 0 and (
                it % args.save_every == 0 or it == args.steps - 1):
            manager.save(it, train_state(params, opt_state, it))
    if first is not None:
        log(f"dp={args.dp} FusedLAMB: loss {first:.4f} -> {loss:.4f} "
            f"({'decreased' if loss < first else 'NOT decreased'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
