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

Each dp rank's loss is its microbatches' mean divided by dp, and the
reductions over dp are sums: the gradient of the global batch's mean
loss, as the reference's means give it, and (for a power-of-two dp) the
same bits. So every cotangent is the global mean loss's, which the fp8
tier's E5M2 observations need.

``--opt-level O4`` (``:145-152``) runs the lm head in fp8 under one
``Fp8DelayedScaler(["lm_head"], history=16)``: the last stage folds its
M microbatches into one lm-head call (``:186-201``), so a step has one
site, and :meth:`Megatron3D.grads` takes the grad probes' gradients
through the step context's ``value_and_grad``. The observations are
voted ``MAX`` over pp, dp and tp (``:212-225``), so every rank holds the
same rings. The stages before the last run no lm head and contribute 0
to the vote; the reference says its earlier stages observe their bubble
activations (``:216-220``), a deliberate difference (ROADMAP.md, Queue
3) that makes the rings those of one device's O4 step on the global
batch.

``--checkpoint-dir DIR [--save-every N] [--resume]`` drives the steps
through ``ResilientTrainLoop`` (``:394-414``): auto-resume from the
newest valid checkpoint, periodic and emergency saves, a ``FaultPlan``
from ``APEX_TPU_FAULT_PLAN``, exit 75 on preemption. Each rank saves its
shards, its optimizer state and, at O4, the fp8 state to ``DIR/rank<r>``
(the reference saves one global checkpoint of the sharded arrays; here
every rank writes its own, as ``gpt2_train.py`` does); the batches are a
pure function of the step, so a resumed run reaches the uninterrupted
run's state.

The observability tiers (``:292-317``, ``:385-405``, ``:428-441``,
:class:`Tiers`): a ``StepReporter`` record a step (tokens a step M x mb x
dp x s), ``StepPhases`` around each step with its clock started before
the batch and the batch under ``span("data/batch")``, a
``StatsCollector`` and a ``MemoryMonitor`` every 8 steps, a
``HealthMonitor`` over the loss, and a ``FlightRecorder`` (10 x the
median step, or ``$APEX_TPU_STALL_DEADLINE`` seconds) whose sensor feeds
the ``PreemptionWatcher``. With ``APEX_TPU_METRICS=PATH`` the run ends by
publishing its goodput and dumping the registry, one
``PATH``-with-``.rank<r>`` file a rank (:func:`dump_metrics`); read them
with ``python -m apex_tpu_torch.observability report|goodput``. The
step's one host read stays the loss.

Not ported here (ROADMAP.md, Queue 1 item 5.4): ``--auto-shard``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Dict, Optional

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
    p.add_argument("--opt-level", default="O0", choices=["O0", "O4"],
                   help="O4: the lm head in fp8 (E4M3 forward, E5M2 "
                        "gradient) under delayed per-tensor scaling")
    p.add_argument("--checkpoint-dir", default="",
                   help="save each rank's train state under DIR/rank<r>")
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step in --checkpoint-dir")
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


FP8_SITES = ("lm_head",)
FP8_HISTORY = 16


class Megatron3D:
    """The reference example's train step over this rank's shards.

    ``cfg``: the model; ``tx``: the optimizer (``fused_adam``);
    ``microbatches`` x ``microbatch_size`` sequences of ``seq`` tokens a
    dp rank a step; ``sequence_parallel``. The grid comes from
    ``parallel_state`` (``initialize_model_parallel``).

    ``opt_level="O4"``: the lm head runs in fp8 under :attr:`fp8` (an
    ``Fp8DelayedScaler`` of :data:`FP8_SITES`); its state is
    :attr:`fp8_state`, fresh rings on ``device``, which every
    :meth:`grads` call moves on by one step."""

    def __init__(self, cfg: llama.LlamaConfig, tx, microbatches: int,
                 microbatch_size: int, seq: int,
                 sequence_parallel: bool = True, opt_level: str = "O0",
                 device=None):
        if opt_level not in ("O0", "O4"):
            raise ValueError(f"opt_level O0 or O4, got {opt_level!r}")
        self.cfg, self.tx = cfg, tx
        self.M, self.mb, self.s = microbatches, microbatch_size, seq
        self.coords = _coords()
        self.sp = sequence_parallel and self.coords["tp"][1] > 1
        if seq % self.coords["tp"][1]:
            raise ValueError(f"seq {seq} must split over tp "
                             f"{self.coords['tp'][1]}")
        self.fp8 = self.fp8_state = None
        if opt_level == "O4":
            from apex_tpu_torch.amp import Fp8DelayedScaler

            self.fp8 = Fp8DelayedScaler(FP8_SITES, history=FP8_HISTORY)
            self.fp8_state = self.fp8.init(device)

    def local_batch(self, tokens: torch.Tensor) -> torch.Tensor:
        """This dp rank's ``[M, mb, s]`` of the global ``[M, mb * dp, s]``
        (the reference's ``P(None, 'dp', None)``)."""
        r, _ = self.coords["dp"]
        return tokens[:, r * self.mb:(r + 1) * self.mb]

    def loss(self, stage, io, tokens, targets):
        """The loss (the mean over this dp rank's microbatches divided by
        dp, summed over pp), differentiable w.r.t. ``stage`` and ``io``;
        ``tokens`` and ``targets`` are this rank's ``[M, mb, s]``. At O4
        the last stage takes the lm head once over the M microbatches
        folded together (``:186-201``): the same mean, one fp8 site."""
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

        if self.fp8 is not None:  # one "microbatch" of all M
            outs = outs.reshape(1, M * mb, *outs.shape[2:])
            targets = targets.reshape(1, M * mb, s)
        loss = _last_stage_mean_loss(mb_loss, outs, targets, "pp")
        return loss / self.coords["dp"][1]

    def _local_grads(self, stage, io, tokens, targets):
        """``(loss, {"stage", "io"} grads)`` of this rank's loss; at O4
        through the fp8 step context, whose update then votes the step's
        observations over every axis."""
        trees = {"stage": stage, "io": io}

        def loss_of(t):
            return self.loss(t["stage"], t["io"], tokens, targets)

        if self.fp8 is not None:
            with self.fp8.step(self.fp8_state) as ctx:
                loss, grads = ctx.value_and_grad(loss_of)(trees)
            self.fp8_state = self.fp8.update(self.fp8_state, ctx,
                                             reduce_axes=AXES)
            return loss, grads
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                trees)
        loss = loss_of(live)
        leaves = _tree.leaves(live)
        # the first stage holds no loss, the others no embedding lookup:
        # their grads are zeros, as the reference's masked ones are
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), _tree.unflatten(_tree.paths(live), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])

    def grads(self, stage, io, tokens, targets):
        """``(loss, stage_grads, io_grads)`` with the reference's
        reductions (``:228-235``) applied: the gradients of the global
        batch's mean loss w.r.t. this rank's shards, and that loss. At O4
        :attr:`fp8_state` moves on by this step."""
        loss, grads = self._local_grads(stage, io, tokens, targets)
        g_stage, g_io = grads["stage"], grads["io"]
        dp = self.coords["dp"][1]
        total = _backend.ReduceOp.SUM
        if dp > 1:
            g_stage = {k: _backend.all_reduce(v, total, "dp")
                       for k, v in g_stage.items()}
        g_io = {k: _backend.all_reduce(v, total, "pp")
                for k, v in g_io.items()}
        if dp > 1:
            g_io = {k: _backend.all_reduce(v, total, "dp")
                    for k, v in g_io.items()}
        if self.sp:  # sequence-parallel norm scales saw this rank's rows
            g_stage = {k: (_backend.all_reduce(v, _backend.ReduceOp.SUM,
                                               "tp")
                           if k.endswith("norm") else v)
                       for k, v in g_stage.items()}
            g_io = {k: (_backend.all_reduce(v, _backend.ReduceOp.SUM, "tp")
                        if k == "final_norm" else v)
                    for k, v in g_io.items()}
        if dp > 1:
            loss = _backend.all_reduce(loss, total, "dp")
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


def train_state(step3d: Megatron3D, stage, io, opt_state) -> Dict:
    """The state a rank checkpoints: its shards, its optimizer state and,
    at O4, the fp8 scaling state."""
    state = {"stage": stage, "io": io, "opt": opt_state}
    if step3d.fp8 is not None:
        state["fp8"] = step3d.fp8_state
    return state


def checkpoint_dir(directory: str, rank: int) -> str:
    """This rank's checkpoint directory under ``directory``."""
    return os.path.join(directory, f"rank{rank}")


class Tiers:
    """The reference example's observability tiers (``:292-317``,
    ``:385-392``) for one rank: ``reporter`` (a ``StepReporter`` with
    ``tokens_per_step``), ``phases``, ``collector`` (every 8 steps over
    the stage and io params), ``health``, ``memmon`` (every 8 steps, on
    ``device``) and ``recorder`` (a ``FlightRecorder`` at 10 x the median
    step, or ``$APEX_TPU_STALL_DEADLINE`` seconds, dumping to
    ``directory``). :func:`run` installs the recorder for its steps; put
    ``recorder.sensor()`` in the ``PreemptionWatcher``."""

    def __init__(self, tokens_per_step: int, device=None,
                 directory: Optional[str] = None):
        from apex_tpu_torch import observability as obs

        self.reporter = obs.StepReporter("llama_train",
                                         tokens_per_step=tokens_per_step)
        self.phases = obs.StepPhases(name="llama_train/step")
        self.collector = obs.StatsCollector("llama_train", every=8)
        self.health = obs.HealthMonitor("llama_train")
        self.memmon = obs.MemoryMonitor("llama_train", every=8,
                                        device=device)
        deadline = os.environ.get("APEX_TPU_STALL_DEADLINE")
        try:
            deadline_s = float(deadline) if deadline else None
        except ValueError:
            raise SystemExit(
                f"APEX_TPU_STALL_DEADLINE={deadline!r} is not a number "
                f"(wall-deadline seconds, e.g. 120)")
        # 10x the median, not the default 3x: a contended host can jitter
        # a step 3x without anything being wedged, and a false stall
        # escalates to exit 75 through the sensor
        self.recorder = obs.FlightRecorder(directory=directory or None,
                                           stall_factor=10.0,
                                           deadline_s=deadline_s)

    def record(self, it: int, st: Dict, loss: float, dt: float) -> dict:
        """The tiers' work after step ``it`` (``:356-362``): the decimated
        stats pass and snapshot, the health detectors, the step record."""
        self.collector.observe({"stage": st["stage"], "io": st["io"]}, it)
        self.health.observe(it, loss=loss)
        self.memmon.observe(it)
        return self.reporter.step(dt, loss=loss, numerics=self.collector.last,
                                  memory=self.memmon.last,
                                  **self.phases.last_fields())


def run(step3d: Megatron3D, state: Dict, num_steps: int,
        batch_of: Callable[[int], tuple], *, directory: Optional[str] = None,
        save_every: int = 5, resume: bool = False, fault_plan=None,
        watcher=None, exit_on_preempt: bool = False, log=None,
        tiers: Optional[Tiers] = None):
    """Steps up to ``num_steps`` under ``ResilientTrainLoop``
    (``:394-414``): ``batch_of(step)`` gives this rank's ``(tokens,
    targets)``; ``directory`` (this rank's) holds the checkpoints, saved
    every ``save_every`` steps and at the last (0: none but an emergency
    save), restored from when ``resume``. ``tiers`` (:class:`Tiers`)
    records every step (``:340-373``) and hands the loop its flight
    recorder and memory monitor. Returns ``(state, losses, loop)``,
    ``losses`` the steps this call ran, by step."""
    from apex_tpu_torch.observability import span
    from apex_tpu_torch.resilience import ResilientTrainLoop

    losses: Dict[int, float] = {}

    def step_fn(st, it):
        with (tiers.phases.step() if tiers is not None
              else contextlib.nullcontext()):
            # t0 before the batch: step_time_ms covers the same window
            # as the phase fractions (ref :330-335)
            t0 = time.perf_counter()
            with span("data/batch"):
                tokens, targets = batch_of(it)
            if step3d.fp8 is not None:
                step3d.fp8_state = st["fp8"]
            loss, opt_state = step3d.train_step(
                st["stage"], st["io"], st["opt"], tokens, targets)
            losses[it] = loss = float(loss)  # the step's one host read
            dt = time.perf_counter() - t0
        new_state = train_state(step3d, st["stage"], st["io"], opt_state)
        if tiers is not None:
            rec = tiers.record(it, new_state, loss, dt)
            msg = (f"({rec['step_time_ms']:.0f} ms  "
                   f"{rec['tokens_per_sec']:.0f} tok/s)")
        else:
            msg = f"({dt * 1e3:.0f} ms)"
        if log is not None:
            log(f"step {it:3d}  loss {loss:.4f}  {msg}")
        return new_state, {"loss": loss}

    loop = ResilientTrainLoop(
        step_fn, directory=directory or None, save_every=save_every,
        max_to_keep=2, fault_plan=fault_plan, watcher=watcher,
        auto_resume=resume, check_state_every=0,
        exit_on_preempt=exit_on_preempt,
        flight_recorder=None if tiers is None else tiers.recorder,
        memory_monitor=None if tiers is None else tiers.memmon,
        on_resume=None if log is None else
        (lambda it: log(f"=> resumed from step {it}")))
    if tiers is not None:
        tiers.recorder.install()
    try:
        state = loop.run(state, num_steps)
    finally:
        if tiers is not None:
            tiers.recorder.uninstall()
    if step3d.fp8 is not None:
        step3d.fp8_state = state["fp8"]
    return state, losses, loop


def dump_metrics(path: str, wall_s: float, registry=None):
    """The run's end under ``APEX_TPU_METRICS`` (``:428-441``): account
    its goodput from the registry's records and publish the
    ``goodput/*`` gauges, then dump the registry to this rank's
    ``rank_path`` variant of ``path``. Returns ``(accounting or None,
    the file written)``; a failed accounting is printed, never fatal."""
    from apex_tpu_torch import observability as obs

    reg = registry if registry is not None else obs.get_registry()
    acc = None
    try:
        ledger = obs.ledger_from_records(reg.to_records())
        acc = obs.account_goodput(ledger, wall_s=wall_s)
        obs.goodput.publish(acc, reg)
    except Exception as e:  # noqa: BLE001 - telemetry must not cost the run
        print(f"goodput accounting failed: {e!r}", flush=True)
    reg.dump(path)
    return acc, reg.dump_path(path)


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel.multiproc import initialize_distributed
    from apex_tpu_torch.resilience import (
        FaultPlan,
        PreemptionWatcher,
        env_sensor,
    )

    t_main0 = time.perf_counter()
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
                        sequence_parallel=not args.no_sequence_parallel,
                        opt_level=args.opt_level, device=device)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    if step3d.fp8 is not None:
        log(f"opt-level O4: lm_head in fp8 (E4M3/E5M2, delayed scaling, "
            f"history={FP8_HISTORY})")

    def batch_of(it):
        tokens, targets = make_batch(it, cfg, M, mb * args.dp, s,
                                     args.fixed_data, device)
        return step3d.local_batch(tokens), step3d.local_batch(targets)

    spec = os.environ.get("APEX_TPU_FAULT_PLAN")
    tiers = Tiers(M * mb * args.dp * s, device=device,
                  directory=args.checkpoint_dir or None)
    watcher = PreemptionWatcher(
        sensors=[env_sensor(), tiers.recorder.sensor()]).install()
    try:
        _, losses, loop = run(
            step3d, train_state(step3d, stage, io,
                                step3d.tx.init({"stage": stage, "io": io})),
            args.steps, batch_of,
            directory=(checkpoint_dir(args.checkpoint_dir, rank)
                       if args.checkpoint_dir else None),
            save_every=args.save_every, resume=args.resume,
            fault_plan=FaultPlan.parse(spec) if spec else None,
            watcher=watcher, exit_on_preempt=True, log=log, tiers=tiers)
    finally:
        watcher.uninstall()
    if not losses:
        log(f"nothing to do: resumed step + 1 "
            f"({(loop.resumed_from or 0) + 1}) >= --steps {args.steps}")
    else:
        first, last = losses[min(losses)], losses[max(losses)]
        log(f"mesh pp={args.pp} dp={args.dp} tp={args.tp} sp={step3d.sp}: "
            f"loss {first:.4f} -> {last:.4f} "
            f"({'decreased' if last < first else 'NOT decreased'})")
    if os.environ.get("APEX_TPU_METRICS"):
        acc, path = dump_metrics(os.environ["APEX_TPU_METRICS"],
                                 time.perf_counter() - t_main0)
        if acc is not None:
            log(f"goodput {acc['goodput_ratio']:.4f} "
                f"(productive {acc['productive_s']:.2f}s of "
                f"{acc['wall_s']:.2f}s wall)")
        log(f"metrics -> {path}")
    ps.destroy_model_parallel()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
