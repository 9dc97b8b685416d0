"""Minimal data-parallel training (port of
``examples/simple_distributed.py``, the counterpart of the reference
CUDA Apex's ``examples/simple/distributed``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 --backend gloo \\
        [--cpu] apex_tpu_torch/examples/simple_distributed.py

One process a rank. A linear model ``w`` [16, 1] on each rank's rows of
a 64-row global batch; a step is the DDP mean of the ranks' gradients
over ``"data"`` (``parallel.sync_gradients``) and ``fused_adam(lr=1e-2)``.
The script asserts the invariant the reference asserts: the synced
gradient equals the global batch's gradient on one device (rtol 1e-5,
atol 1e-6); then that 100 steps converge (loss < 0.01). Rank 0 prints
the reference's two ``OK`` lines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.parallel import sync_gradients

ROWS, FEATURES = 64, 16


def local_loss(w, x, y):
    return torch.mean((x @ w - y) ** 2)


def make_train_step(tx, axis_name: str = "data"):
    """The step (the reference's shard_map body, ``:39``): this rank's
    gradient, its mean over ``axis_name`` (equal shards: the global
    batch's mean gradient), the update. Returns ``(w, opt_state, loss,
    grad)``: the loss the mean of the ranks' losses at the old ``w``."""

    def train_step(w, opt_state, x, y):
        live = w.detach().requires_grad_()
        loss = local_loss(live, x, y)
        (grad,) = torch.autograd.grad(loss, [live])
        grad = sync_gradients(grad, axis_name)
        updates, opt_state = tx.update(grad, opt_state, w)
        loss = _backend.all_reduce(loss.detach(), _backend.ReduceOp.AVG,
                                   axis_name)
        return w + updates, opt_state, loss, grad

    return train_step


def global_batch(device):
    """The reference's data: x [64, 16] normal, y = x @ 0.5 + 0.1, from a
    seeded generator, the same on every rank."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(ROWS, FEATURES, generator=gen)
    y = x @ torch.full((FEATURES, 1), 0.5) + 0.1
    return x.to(device), y.to(device)


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    del argv
    rank, n, device = initialize_distributed()
    if ROWS % n:
        raise SystemExit(f"{ROWS} rows do not split over {n} ranks")
    x, y = global_batch(device)
    rows = ROWS // n
    xl, yl = x[rank * rows:(rank + 1) * rows], y[rank * rows:(rank + 1) * rows]

    w = torch.zeros((FEATURES, 1), device=device)
    tx = fused_adam(lr=1e-2)
    opt_state = tx.init(w)
    step = make_train_step(tx)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    # invariant: synced grad == single-device grad of the global batch
    _, _, _, synced = step(w, opt_state, xl, yl)
    live = w.detach().requires_grad_()
    (full,) = torch.autograd.grad(local_loss(live, x, y), [live])
    np.testing.assert_allclose(synced.cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    log("DDP grad == global-batch grad: OK")

    for _ in range(100):
        w, opt_state, loss, _ = step(w, opt_state, xl, yl)
    log(f"final loss {float(loss):.6f} (started ~{0.1 ** 2 + 0.25:.2f})")
    assert float(loss) < 0.01
    log("converged: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
