"""ImageNet-style ResNet trainer (port of ``examples/imagenet_resnet50.py``,
the counterpart of the reference CUDA Apex's ``examples/imagenet/
main_amp.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 --backend gloo \\
        [--cpu] apex_tpu_torch/examples/imagenet_resnet50.py --smoke
    ... imagenet_resnet50.py --epochs 3 --steps-per-epoch 30
    ... imagenet_resnet50.py --resume auto --checkpoint-dir DIR --evaluate
    ... imagenet_resnet50.py --arch resnet50 --image-size 224

Flag for flag the reference's CLI; the world size of the launch replaces
``--devices``. One process a rank, each holding the fp32 master params
and taking its rows of every global batch. A step
(:class:`DataParallelResNetStep`):

1. the model params cast by the amp policy (O2: bf16, every
   ``BatchNorm_*`` leaf fp32 under ``keep_batchnorm_fp32``), the forward
   in train mode (SyncBatchNorm over ``"data"`` unless ``--no-sync-bn``),
   softmax cross entropy, the loss scaled;
2. the gradients in fp32 (the cast's backward), their mean over
   ``"data"`` (DDP; one all-reduce a dtype); under ``--no-sync-bn`` the
   ranks' new batch stats averaged too (each rank's are its own
   batch's);
3. amp's ``scaled_update`` with ``fused_sgd`` over the warm-up +
   step-decay schedule on the fp32 masters.

With SyncBatchNorm the statistics are the global batch's, so the step's
gradient equals one device's autograd over the whole batch.

Data: ``--data DIR`` reads ``*.npz`` shards holding ``x`` [N, H, W, 3]
and ``y`` [N]; without it a seeded synthetic set is generated (class-
dependent means, so it is learnable). Batches come through
``runtime.PrefetchLoader``'s worker threads. Validation reports top-1
and top-5 with the counts summed over the ranks; rank 0 checkpoints
each epoch and keeps the best accuracy; ``--resume auto`` restarts from
``--checkpoint-dir``.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.models import resnet


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="apex_tpu_torch imagenet trainer (ref main_amp.py)")
    p.add_argument("--val-data", default="", metavar="DIR",
                   help="held-out shards for validation; without it the "
                        "val metrics are measured on the TRAINING shards "
                        "(a warning is printed)")
    p.add_argument("--data", default="", metavar="DIR",
                   help="dir of .npz shards (x,y); synthetic if empty")
    p.add_argument("--arch", "-a", default="tiny",
                   choices=["tiny", "resnet50", "resnet101"])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("-b", "--batch", type=int, default=32,
                   help="global batch size")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", type=float, default=1.0)
    p.add_argument("--decay-epochs", type=int, nargs="*",
                   default=[30, 60, 80],
                   help="epochs at which lr steps down 10x (ref "
                        "adjust_learning_rate)")
    p.add_argument("--print-freq", "-p", type=int, default=10)
    p.add_argument("--workers", "-j", type=int, default=2,
                   help="prefetch worker threads (DataLoader analog)")
    p.add_argument("--resume", default="", metavar="PATH",
                   help="checkpoint dir to resume from ('auto' = "
                        "--checkpoint-dir)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save checkpoints here each epoch (empty = no "
                        "saving)")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="validate only, no training")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--keep-batchnorm-fp32", default=None,
                   choices=[None, "True", "False"])
    p.add_argument("--loss-scale", default=None,
                   help="float or 'dynamic' (default: opt-level policy)")
    p.add_argument("--no-sync-bn", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="tiny 1-epoch run that asserts the loss decreased "
                        "(CI path)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.smoke:
        # shrink everything not given on the command line (a value equal
        # to the default cannot be told from an unset one)
        given = set(argv)

        def absent(*flags):
            return not (given & set(flags))

        if absent("--arch", "-a"):
            args.arch = "tiny"
        if absent("--steps-per-epoch"):
            args.steps_per_epoch = 10
        if absent("--batch", "-b"):
            args.batch = 32
        if absent("--image-size"):
            args.image_size = 32
        if absent("--epochs"):
            args.epochs = 1
    if args.loss_scale not in (None, "dynamic"):
        args.loss_scale = float(args.loss_scale)
    return args


# ------------------------------------------------------------------- data


class ShardDataset:
    """npz shards or seeded synthetic batches (``:107``); one sample row
    is ``[pixels..., label]`` so the loader carries one buffer. A batch
    is the global batch; each rank takes its rows (:meth:`unpack`)."""

    # shard access is sequential and cyclic: a small LRU suffices, and an
    # unbounded cache would hold the whole dataset in host memory
    _CACHE_SHARDS = 4

    def __init__(self, data_dir, n_batches, batch, image_size, classes,
                 seed):
        self.batch, self.hw, self.classes = batch, image_size, classes
        self.n_batches = n_batches
        self.seed = seed
        self.row = image_size * image_size * 3 + 1
        self._cache = collections.OrderedDict()
        self._cache_lock = threading.Lock()
        self.files = []
        if data_dir:
            self.files = sorted(
                os.path.join(data_dir, f) for f in os.listdir(data_dir)
                if f.endswith(".npz"))
            if not self.files:
                raise FileNotFoundError(f"no .npz shards in {data_dir}")

    def _shard(self, path):
        """A decompressed shard, from the LRU when it is there; the lock
        keeps the LRU consistent across the loader's workers."""
        with self._cache_lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
            f = np.load(path)
            shard = (np.asarray(f["x"]), np.asarray(f["y"]))
            self._cache[path] = shard
            while len(self._cache) > self._CACHE_SHARDS:
                self._cache.popitem(last=False)
            return shard

    def fill(self, batch_idx, out):
        """The loader's callback: batch ``batch_idx`` into ``out`` [batch,
        row] float32 (on a worker thread)."""
        if self.files:
            xs, ys = self._shard(self.files[batch_idx % len(self.files)])
            n = len(ys)
            idx = (np.arange(self.batch) + batch_idx * self.batch) % n
            out[:, :-1] = xs[idx].astype(np.float32).reshape(self.batch, -1)
            out[:, -1] = ys[idx]
            return
        rng = np.random.default_rng(self.seed + batch_idx)
        y = rng.integers(0, self.classes, self.batch)
        # class-dependent means make the synthetic data learnable
        x = rng.standard_normal((self.batch, self.row - 1),
                                dtype=np.float32)
        x *= 0.5
        x += ((y / self.classes - 0.5) * 2.0).astype(np.float32)[:, None]
        out[:, :-1] = x
        out[:, -1] = y

    def unpack(self, rows, rank: int = 0, n: int = 1, device=None):
        """This rank's ``(x [b, H, W, 3], y [b])`` of a global batch of
        rows, on ``device``."""
        b = self.batch // n
        mine = torch.from_numpy(rows[rank * b:(rank + 1) * b]).to(device)
        x = mine[:, :-1].reshape(b, self.hw, self.hw, 3)
        return x, mine[:, -1].long()

    def loader(self, n_slots, n_workers):
        from apex_tpu_torch.runtime.host import PrefetchLoader

        return PrefetchLoader(self.fill, self.n_batches,
                              (self.batch, self.row), np.float32,
                              n_slots=n_slots, n_workers=max(n_workers, 1))


# --------------------------------------------------------------- schedule


def lr_schedule(lr: float, steps_per_epoch: int, warmup_epochs: float,
                decay_epochs):
    """The reference's ``optax.join_schedules`` (``:239-249``): a linear
    warm-up from ``lr / 10`` to ``lr`` over the first epochs, then ``lr``
    divided by 10 after each decay epoch. The second schedule sees
    ``step - warmup``, so its boundaries are shifted into that frame.
    ``count`` is the optimizer's int count; the value is fp32."""
    warmup = max(int(warmup_epochs * steps_per_epoch), 1)
    bounds = sorted(int(e * steps_per_epoch) - warmup for e in decay_epochs
                    if int(e * steps_per_epoch) > warmup)

    def schedule(count):
        step = int(count)
        if step < warmup:
            frac = 1.0 - min(max(step, 0), warmup) / warmup
            return torch.tensor((lr / 10 - lr) * frac + lr,
                                dtype=torch.float32)
        value = torch.tensor(lr, dtype=torch.float32)
        for b in bounds:
            if step - warmup > b:
                value = value * 0.1
        return value

    return schedule


# -------------------------------------------------------------------- step


def cross_entropy(logits, y):
    """Mean softmax cross entropy on integer labels, in fp32."""
    return F.cross_entropy(logits.float(), y)


def accuracy_counts(logits, y, topk=(1, 5)):
    """Correct counts for each top-k (ref ``accuracy_counts``)."""
    out = []
    for k in topk:
        top = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).indices
        out.append((top == y[:, None]).any(-1).sum())
    return out


class DataParallelResNetStep:
    """The example's step over this rank's rows (the reference's
    ``train_step``, ``:251``). ``handle`` is amp's (its policy casts the
    masters, its scaler scales the loss), ``tx`` the optimizer over the
    fp32 masters. With ``axis_name`` None (or nothing bound to it) the
    step is one device's: no reduction at all."""

    def __init__(self, model: resnet.ResNet, handle, tx,
                 axis_name: Optional[str] = "data"):
        self.model, self.handle, self.tx = model, handle, tx
        bound = axis_name is not None and _backend.is_initialized() and \
            _backend.is_bound(axis_name)
        self.axis = axis_name if bound else None

    def grads(self, master, batch_stats, x, y, sstate):
        """``(grads, loss, new_stats)``: the scaled loss's fp32 gradients
        w.r.t. the masters (averaged over the ranks), the unscaled loss
        (averaged) and the new batch stats."""
        params = self.handle.policy.cast_model(master)
        live = _tree.map_leaves(lambda p: p.requires_grad_(), params)
        logits, new_stats = self.model.apply(
            {"params": live, "batch_stats": batch_stats}, x, train=True)
        loss = cross_entropy(logits, y)
        g = torch.autograd.grad(self.handle.scale(loss, sstate),
                                _tree.leaves(live))
        del live, params, logits
        grads = _tree.unflatten(_tree.paths(master), [t.float() for t in g])
        del g
        loss = loss.detach()
        if self.axis is not None:
            from apex_tpu_torch.parallel import sync_gradients_flat

            grads = sync_gradients_flat(grads, self.axis)
            avg = _backend.ReduceOp.AVG
            if not self.model.sync_bn:
                # each rank's stats are its own batch's: the stored tree
                # is one, their mean
                new_stats = _tree.map_leaves(
                    lambda s: _backend.all_reduce(s, avg, self.axis),
                    new_stats)
            loss = _backend.all_reduce(loss, avg, self.axis)
        return grads, loss, new_stats

    def step(self, master, opt_state, sstate, batch_stats, x, y):
        """One step: the masters updated in place; ``(opt_state, sstate,
        new_stats, loss, overflow)``."""
        grads, loss, new_stats = self.grads(master, batch_stats, x, y,
                                            sstate)
        updates, opt_state, sstate, overflow = self.handle.scaled_update(
            self.tx, grads, opt_state, master, sstate)
        del grads
        with torch.no_grad():
            for p, u in zip(_tree.leaves(master), _tree.leaves(updates)):
                p.add_(u)
        return opt_state, sstate, new_stats, loss, overflow

    def eval_counts(self, master, batch_stats, x, y):
        """Top-1 and top-5 correct counts, summed over the ranks."""
        with torch.no_grad():
            logits, _ = self.model.apply(
                {"params": self.handle.policy.cast_model(master),
                 "batch_stats": batch_stats}, x, train=False)
            counts = torch.stack(accuracy_counts(logits.float(), y))
        if self.axis is not None:
            counts = _backend.all_reduce(counts, group=self.axis)
        return [int(c) for c in counts]


def train_state(master, opt_state, sstate, batch_stats, epoch: int,
                best_acc1: float):
    return {"params": master, "opt_state": opt_state, "sstate": sstate,
            "batch_stats": batch_stats,
            "epoch": torch.tensor(epoch, dtype=torch.int32),
            "best_acc1": torch.tensor(best_acc1, dtype=torch.float32)}


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch import amp
    from apex_tpu_torch.checkpoint import CheckpointManager
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    if args.deterministic:
        np.random.seed(0)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    rank, n, device = initialize_distributed()
    if args.batch % n:
        raise SystemExit(f"global batch {args.batch} does not split over "
                         f"{n} ranks")

    def log(msg, file=None):
        if rank == 0:
            print(msg, file=file, flush=True)

    build = {"tiny": resnet.tiny, "resnet50": resnet.resnet50,
             "resnet101": resnet.resnet101}[args.arch]
    model = build(num_classes=args.classes, sync_bn=not args.no_sync_bn,
                  axis_name="data",
                  dtype=torch.bfloat16 if args.opt_level in ("O2", "O3")
                  else torch.float32)
    ds = ShardDataset(args.data, args.steps_per_epoch, args.batch,
                      args.image_size, args.classes, seed=100)
    # validation needs held-out shards: measured on the training shards
    # top-1/top-5 overstate, and so does the best checkpoint's choice
    if args.data and not args.val_data:
        log("WARNING: no --val-data given; validation metrics are "
            "measured on the TRAINING shards and overstate accuracy",
            file=sys.stderr)
    val_ds = ShardDataset(args.val_data or args.data, 4, args.batch,
                          args.image_size, args.classes, seed=9000)

    variables = resnet.init_variables(torch.Generator().manual_seed(1),
                                      model, device=device)
    master, batch_stats = variables["params"], variables["batch_stats"]
    # amp resolves the opt level and the overrides into the dtype policy
    # and the scaler (ref main_amp.py amp.initialize)
    handle = amp.initialize(None, opt_level=args.opt_level,
                            keep_batchnorm_fp32=args.keep_batchnorm_fp32,
                            loss_scale=args.loss_scale, verbosity=0)
    sstate = handle.scaler_state
    spe = args.steps_per_epoch
    lr_sched = lr_schedule(args.lr, spe, args.warmup_epochs,
                           args.decay_epochs)
    tx = fused_sgd(lr=lr_sched, momentum=args.momentum,
                   weight_decay=args.weight_decay)
    opt_state = tx.init(master)  # fp32 master state (O2 master weights)
    step = DataParallelResNetStep(model, handle, tx)

    manager = None
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir, max_to_keep=3)
    best_acc1 = 0.0
    start_epoch = args.start_epoch
    resume_dir = (args.checkpoint_dir if args.resume == "auto"
                  else args.resume)
    if resume_dir:
        rm = CheckpointManager(resume_dir)
        if rm.latest_step() is not None:
            state = rm.restore(train_state(master, opt_state, sstate,
                                           batch_stats, 0, 0.0))
            master, opt_state = state["params"], state["opt_state"]
            sstate, batch_stats = state["sstate"], state["batch_stats"]
            start_epoch = int(state["epoch"]) + 1
            best_acc1 = float(state["best_acc1"])
            log(f"=> resumed from '{resume_dir}' (epoch "
                f"{int(state['epoch'])}, best_acc1 {best_acc1:.3f})")
        else:
            log(f"=> no checkpoint found at '{resume_dir}'")

    def validate():
        """Top-1/top-5 over the val split (ref ``validate``)."""
        seen, c1, c5 = 0, 0, 0
        for rows in val_ds.loader(2, args.workers):
            x, y = val_ds.unpack(rows, rank, n, device)
            a, b = step.eval_counts(master, batch_stats, x, y)
            c1, c5, seen = c1 + a, c5 + b, seen + args.batch
        log(f"val: top1 {100 * c1 / seen:.2f}%  top5 {100 * c5 / seen:.2f}%"
            f"  ({seen})")
        return 100 * c1 / seen

    if args.evaluate:
        validate()
        return 0

    first_loss = last_loss = None
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        seen = 0
        for it, rows in enumerate(ds.loader(4, args.workers)):
            x, y = ds.unpack(rows, rank, n, device)
            opt_state, sstate, batch_stats, loss, overflow = step.step(
                master, opt_state, sstate, batch_stats, x, y)
            seen += args.batch
            if first_loss is None:
                first_loss = float(loss)
                t0 = time.perf_counter()  # leave out the first step
                seen = 0
            if it % args.print_freq == 0 or it == spe - 1:
                lr_now = float(lr_sched(epoch * spe + it))
                log(f"epoch {epoch:3d} step {it:4d}  "
                    f"loss {float(loss):.4f}  lr {lr_now:.4f}  "
                    f"scale {float(sstate.loss_scale):.0f}  "
                    f"overflow {bool(overflow)}")
        loss = float(loss)  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        if seen:
            log(f"epoch {epoch}: {seen / dt:.1f} images/s")
        last_loss = loss
        acc1 = validate()
        if manager is not None:
            is_best = acc1 > best_acc1
            best_acc1 = max(acc1, best_acc1)
            if rank == 0:
                manager.save(epoch, train_state(master, opt_state, sstate,
                                                batch_stats, epoch,
                                                best_acc1))
            _backend.barrier("data")
            log(f"=> saved epoch {epoch}" + (" (new best)" if is_best
                                             else ""))

    if first_loss is not None:
        verdict = "decreased" if last_loss < first_loss else "NOT decreased"
        log(f"loss {first_loss:.4f} -> {last_loss:.4f} ({verdict})")
        # a resumed run starts near the tiny synthetic set's loss floor,
        # so the decrease is required only from scratch
        if args.smoke and start_epoch == 0 and last_loss >= first_loss:
            raise SystemExit("smoke: loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
