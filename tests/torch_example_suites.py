"""The port's side of the multi-rank tests of the test harness
(``apex_tpu_torch.transformer.testing``) and of the 3-D example's O4,
checkpoint and observability paths
(``apex_tpu_torch.examples.llama_train``): suites that
run on every rank of a gloo group on the CPU (through
``torch_dist_worker.run_ranks``) and save what they computed. This file
imports torch and the port, never JAX.
"""

from __future__ import annotations

import unittest

import numpy as np

from torch_dist_worker import _np, _t

HARNESS_ARGS = ["--num-layers", "4", "--hidden-size", "16",
                "--num-attention-heads", "2", "--seq-length", "16",
                "--padded-vocab-size", "64", "--micro-batch-size", "2",
                "--pipeline-model-parallel-size", "2"]


def _harness_base_cases():
    """DistributedTestBase subclasses: one that fits 2 ranks (pp 2), one
    that needs 4 (tp 2 x pp 2) and skips."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        DistributedTestBase,
    )

    class Fits(DistributedTestBase):
        PP = 2

        def test_mesh_alive(self):
            assert self.mesh.shape["pp"] == 2
            assert ps.get_pipeline_model_parallel_world_size() == 2
            assert ps.get_tensor_model_parallel_world_size() == 1

    class TooBig(DistributedTestBase):
        TP, PP = 2, 2

        def test_never_runs(self):
            raise AssertionError("a 4-rank case ran on 2 ranks")

    return Fits, TooBig


def suite_harness_pipeline(rank, n, inp, directory):
    """The harness on 2 ranks: DistributedTestBase over the world's gloo
    groups, ``initialize_distributed`` and ``build_mesh``, then the
    standalone GPT and BERT through the collective pipeline at pp 2
    (``inp``: ``gpt_tokens`` and ``bert_tokens``, ``bert_targets``,
    ``bert_mask`` as [M, mb, s]): each model's loss, this rank's stage
    gradients and the io gradients summed over pp."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        _last_stage_mean_loss,
        pipelined_forward,
    )
    from apex_tpu_torch.transformer.testing import (
        build_mesh,
        global_vars,
        initialize_distributed,
        standalone_bert,
        standalone_gpt,
    )

    out = {}
    result = unittest.TextTestRunner(verbosity=0, stream=open(
        directory / f"unittest_r{rank}.log", "w")).run(unittest.TestSuite(
            unittest.defaultTestLoader.loadTestsFromTestCase(case)
            for case in _harness_base_cases()))
    out["base_ok"] = np.array(result.wasSuccessful())
    out["base_run"] = np.array(result.testsRun)
    out["base_skipped"] = np.array(len(result.skipped))
    mesh = initialize_distributed(tp=1, pp=2)
    out["mesh_pp"] = np.array(mesh.shape["pp"])
    out["mesh_dp"] = np.array(mesh.shape["dp"])
    out["build_mesh"] = np.array(build_mesh((2, 1), ("pp", "tp")).shape[
        "pp"])
    for name, provider in (("gpt", standalone_gpt.gpt_model_provider),
                           ("bert", standalone_bert.bert_model_provider)):
        global_vars.destroy_global_vars()
        args = global_vars.set_global_variables(args=HARNESS_ARGS)
        cfg, init_params, split_stages, embed, stage_fn, head = provider(
            args)
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        stage = {k: v[rank].clone().requires_grad_()
                 for k, v in split_stages(params, 2).items()}
        io = {k: v.clone().requires_grad_()
              for k, v in standalone_gpt.io_params(params).items()}
        tokens = _t(inp[f"{name}_tokens"]).long()
        if name == "gpt":
            rest = [torch.roll(tokens, -1, dims=-1)]
        else:
            rest = [_t(inp["bert_targets"]).long(), _t(inp["bert_mask"])]
        if rank == 0:
            x_mb = torch.stack([embed(io, t, cfg, tp_axis="tp")
                                for t in tokens])
        else:
            x_mb = torch.zeros(tokens.shape + (cfg.hidden_size,))
        outs = pipelined_forward(
            lambda sp, x: stage_fn(sp, x, cfg, tp_axis="tp"), stage, x_mb,
            axis_name="pp", remat=False)
        # each microbatch's (targets[, loss mask])
        loss = _last_stage_mean_loss(
            lambda o, t: head(io, o, *t, cfg, tp_axis="tp"), outs,
            list(zip(*rest)), "pp")
        leaves = _tree.leaves({"io": io, "stage": stage})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _tree.unflatten(_tree.paths({"io": io, "stage": stage}), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        out[f"{name}_loss"] = _np(loss)
        for k, g in grads["stage"].items():
            out[f"{name}_gstage_{k}"] = _np(g)
        for k, g in grads["io"].items():
            out[f"{name}_gio_{k}"] = _np(B.all_reduce(g, B.ReduceOp.SUM,
                                                      "pp"))
    global_vars.destroy_global_vars()
    ps.destroy_model_parallel()
    return out


# ----------------------------------------------- the 3-D example at O4

# (tag, tp, pp): 4 ranks, so dp = 4 // (tp * pp)
O4_GRIDS = (("tp2pp2", 2, 2), ("dp2pp2", 1, 2))
O4_M, O4_MB, O4_SEQ, O4_STEPS, O4_LR = 2, 1, 16, 2, 1e-3
RESUME_STEPS = 3


def o4_step(opt_level: str, tp: int, pp: int, device="cpu"):
    """The example's 3-D step at the test size on the bound grid: one
    layer a stage, M x mb sequences of O4_SEQ tokens a dp rank, sequence
    parallel, flat Adam; the full fp32 params from seed 0."""
    import torch

    from apex_tpu_torch.examples import llama_train as ex
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam

    cfg = ex.tiny_config(pp, tp, 1, O4_SEQ)
    full = llama.init_params(torch.Generator().manual_seed(0), cfg,
                             device=device)
    step = ex.Megatron3D(cfg, fused_adam(lr=O4_LR, flat=True), O4_M, O4_MB,
                         O4_SEQ, sequence_parallel=True, opt_level=opt_level,
                         device=device)
    return cfg, full, step


def o4_batch(step, cfg, it):
    """This dp rank's (tokens, targets) of step ``it``."""
    from apex_tpu_torch.examples import llama_train as ex

    dp = step.coords["dp"][1]
    tokens, targets = ex.make_batch(it, cfg, O4_M, O4_MB * dp, O4_SEQ)
    return step.local_batch(tokens), step.local_batch(targets)


def state_sha1(state) -> str:
    """SHA-1 over every tensor of a train state, in tree order (bf16 by
    its bits)."""
    import hashlib

    import torch

    from apex_tpu_torch import _tree

    h = hashlib.sha1()
    for leaf in _tree.flatten(state)[0]:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def suite_llama_o4(rank, n, inp, directory):
    """The example's 3-D step at O4 on 4 ranks, for each grid of
    O4_GRIDS: O4_STEPS steps, each step's loss, gradient blocks and the
    fp8 rings after its update, and the shards each step started from.
    Then on tp 2 x pp 2, at O0 and at O4, the
    resilient loop's round trip: RESUME_STEPS uninterrupted steps; a run
    preempted after step 1 (its emergency save); a resumed run from a
    template of other params. The two final states' SHA-1s."""
    import torch

    from apex_tpu_torch.examples import llama_train as ex
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.resilience import FaultPlan, Preempted
    from apex_tpu_torch.transformer import parallel_state as ps

    out = {}
    for tag, tp, pp in O4_GRIDS:
        ps.initialize_model_parallel(tp, pp)
        cfg, full, step = o4_step("O4", tp, pp)
        stage, io = ex.shard_params(full, cfg)
        opt_state = step.tx.init({"stage": stage, "io": io})
        for it in range(O4_STEPS):
            for k, p in {**stage, **io}.items():
                out[f"{tag}_p{it}_{k}"] = _np(p)
            loss, g_stage, g_io = step.grads(stage, io,
                                             *o4_batch(step, cfg, it))
            out[f"{tag}_loss{it}"] = _np(loss)
            for k, g in {**g_stage, **g_io}.items():
                out[f"{tag}_g{it}_{k}"] = _np(g)
            out[f"{tag}_fwd{it}"] = _np(step.fp8_state.fwd.ring)
            out[f"{tag}_grad{it}"] = _np(step.fp8_state.grad.ring)
            opt_state = step.apply(stage, io, opt_state, g_stage, g_io)
        out[f"{tag}_coords"] = np.array([step.coords[a][0]
                                         for a in ("pp", "dp", "tp")])
        ps.destroy_model_parallel()

    ps.initialize_model_parallel(2, 2)
    for level in ("O0", "O4"):
        def fresh(seed):
            cfg, full, step = o4_step(level, 2, 2)
            if seed:
                full = llama.init_params(torch.Generator().manual_seed(seed),
                                         cfg, device="cpu")
            stage, io = ex.shard_params(full, cfg)
            return cfg, step, ex.train_state(
                step, stage, io, step.tx.init({"stage": stage, "io": io}))

        cfg, step, state = fresh(0)
        state, losses, _ = ex.run(step, state, RESUME_STEPS,
                                  lambda it: o4_batch(step, cfg, it))
        out[f"{level}_sha_uninterrupted"] = np.array(state_sha1(state))
        out[f"{level}_losses"] = np.array([losses[i] for i in sorted(losses)])
        ckpt = ex.checkpoint_dir(str(directory / level), rank)
        cfg, step, state = fresh(0)
        try:
            ex.run(step, state, RESUME_STEPS,
                   lambda it: o4_batch(step, cfg, it), directory=ckpt,
                   save_every=0, fault_plan=FaultPlan.parse("preempt@1"))
            out[f"{level}_preempted_at"] = np.array(-1)
        except Preempted as exc:
            out[f"{level}_preempted_at"] = np.array(exc.step)
        logs = []
        cfg, step, state = fresh(5)  # other params: the restore must win
        state, losses, loop = ex.run(
            step, state, RESUME_STEPS, lambda it: o4_batch(step, cfg, it),
            directory=ckpt, save_every=0, resume=True, log=logs.append)
        out[f"{level}_resumed_from"] = np.array(loop.resumed_from)
        out[f"{level}_resumed_steps"] = np.array(sorted(losses))
        out[f"{level}_resume_log"] = np.array(logs[0] if logs else "")
        out[f"{level}_sha_resumed"] = np.array(state_sha1(state))
        if level == "O4":
            out["O4_fp8_steps"] = np.array(int(step.fp8_state.steps))
    ps.destroy_model_parallel()
    return out


TIERS_STEPS = 3


def suite_llama_tiers(rank, n, inp, directory):
    """The example at its tiny defaults on pp 2 (2 ranks): TIERS_STEPS
    steps with the observability tiers off, then the same steps from the
    same init with them on (a fresh registry), ended as ``main`` ends
    under ``APEX_TPU_METRICS``: goodput published, the registry dumped
    to ``directory/metrics.jsonl`` (this rank's ``.rank<r>`` variant).
    Each run's losses; the dump's path."""
    import time

    import torch

    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.examples import llama_train as ex
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer import parallel_state as ps

    t0 = time.perf_counter()
    args = ex.parse_args(["--pp", "2", "--dp", "1", "--tp", "1"])
    M, mb, s = args.microbatches, args.microbatch_size, args.seq
    ps.initialize_model_parallel(args.tp, args.pp)

    def fresh():
        cfg = ex.tiny_config(args.pp, args.tp, args.layers_per_stage, s)
        params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        stage, io = ex.shard_params(params, cfg)
        step = ex.Megatron3D(cfg, fused_adam(lr=args.lr), M, mb, s,
                             sequence_parallel=True, device="cpu")
        state = ex.train_state(step, stage, io,
                               step.tx.init({"stage": stage, "io": io}))

        def batch_of(it):
            tokens, targets = ex.make_batch(it, cfg, M, mb * args.dp, s,
                                            device="cpu")
            return step.local_batch(tokens), step.local_batch(targets)
        return step, state, batch_of

    step, state, batch_of = fresh()
    _, off, _ = ex.run(step, state, TIERS_STEPS, batch_of)
    prev = obs.set_registry(obs.MetricRegistry())
    try:
        step, state, batch_of = fresh()
        tiers = ex.Tiers(M * mb * args.dp * s, device="cpu",
                         directory=str(directory))
        _, on, _ = ex.run(step, state, TIERS_STEPS, batch_of, tiers=tiers)
        acc, path = ex.dump_metrics(str(directory / "metrics.jsonl"),
                                    time.perf_counter() - t0)
    finally:
        obs.set_registry(prev)
    ps.destroy_model_parallel()
    return {"off": np.array([off[i] for i in sorted(off)]),
            "on": np.array([on[i] for i in sorted(on)]),
            "path": np.array(path),
            "goodput": np.array(acc["goodput_ratio"])}


SUITES = {"harness_pipeline": suite_harness_pipeline,
          "llama_o4": suite_llama_o4, "llama_tiers": suite_llama_tiers}

