"""The port's side of the multi-rank CPU tests: each suite runs on every
rank of a gloo group on the CPU and saves what it computed.

Test side: :func:`run_ranks` writes the inputs (numpy arrays made from a
seed by the test) to ``inputs.npz``, starts one process per rank
(``python tests/torch_dist_worker.py SUITE DIR``; the ranks meet through
a ``FileStore`` in ``DIR``, so concurrent test workers never share a
port) and returns each rank's results, a dict of numpy arrays from
``rank<r>.npz``. Rank side: :func:`main` runs ``SUITES[SUITE](rank, n,
inputs, dir)``. This file imports torch and the port, never JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ test side

def run_ranks(suite: str, n: int, directory, inputs: dict,
              timeout: float = 240.0, cpu: bool = True) -> list:
    """Run ``suite`` on ``n`` gloo ranks, on the CPU (else every rank on
    GPU 0); each rank's results. A rank that fails fails the call, with
    its output."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    np.savez(directory / "inputs.npz", **inputs)
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", APEX_TPU_TORCH_CPU="1" if cpu else "0",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(directory)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise RuntimeError(f"suite {suite}: ranks failed: {bad}")
    out = []
    for r in range(n):
        with np.load(directory / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


# ------------------------------------------------------------ rank side

def _np(t):
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # the bits
    return t.numpy().copy()  # not a view of a tensor updated later


def _t(a, dtype=None):
    import torch

    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _error(fn) -> str:
    """The name and message of what ``fn()`` raises ('' if nothing)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — reported to the test
        return f"{type(exc).__name__}: {exc}"
    return ""


def suite_backend(rank, n, inp, directory):
    """Collectives and divergence on 4 ranks (tests/test_torch_
    distributed.py)."""
    import torch

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.distributed import divergence as D

    out = {}
    x = _t(inp["ops"][rank:rank + 1])
    for op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
        out[f"op_{op}"] = _np(B.all_reduce(x, getattr(B.ReduceOp, op)))
    xg = _t(inp["gather"][rank])
    full = B.all_gather(xg, "dp")
    out["gather"] = _np(full)
    out["roundtrip"] = _np(B.reduce_scatter(full, "dp") / n)
    out["gather_stacked"] = _np(B.all_gather(xg, "dp", tiled=False))
    out["gather_axis1"] = _np(B.all_gather(xg[None], "dp", axis=1))
    out["bcast"] = _np(B.broadcast(_t(inp["bcast"][rank]), src=2))
    out["a2a"] = _np(B.all_to_all(_t(inp["a2a"][rank:rank + 1]), "dp",
                                  split_axis=1, concat_axis=0))
    # a 2 x 2 grid of ranks: "mdp" joins the ranks of one column, "mtp"
    # those of one row (the reference's Mesh(reshape(2, 2), ("dp", "tp")))
    for r0 in range(2):
        B.new_group("mtp", ranks=[2 * r0, 2 * r0 + 1])
    for c in range(2):
        B.new_group("mdp", ranks=[c, c + 2])
    B.bind(("mdp", "mtp"), B.get_group("dp"))
    grid = ("mdp", "mtp")
    out["grid_rank"] = np.array(B.get_rank(grid))
    out["grid_sum"] = _np(B.all_reduce(x, B.ReduceOp.SUM, grid))
    out["grid_avg"] = _np(B.all_reduce(x, B.ReduceOp.AVG, grid))
    out["grid_row_sum"] = _np(B.all_reduce(x, B.ReduceOp.SUM, "mtp"))
    out["grid_bcast"] = _np(B.broadcast(x, src=3, group=grid))
    out["init"] = np.array([B.is_initialized(), B.get_world_size(),
                            B.barrier()])
    # differentiable SUM: d/dx of sum_r(w_r . all_reduce(x)) on each rank
    xr = x.clone().requires_grad_()
    w = _t(inp["ops"][rank:rank + 1]) * 10.0
    (B.all_reduce(xr) * w).sum().backward()
    out["grad_all_reduce"] = _np(xr.grad)
    # divergence: this rank's digest of its tree, and the verdicts
    tree = {"a": _t(inp["div_a"]), "b": _t(inp["div_b"])}
    out["digest_same"] = np.array(D._fingerprint(tree)[0], np.int64)
    out["div_same"] = _np(D.replica_divergence(tree, "dp"))
    drift = {"a": _t(inp["div_a"]).clone(), "b": _t(inp["div_b"])}
    if rank == 3:
        drift["a"][0, 0] += 1e-3
    ok, div = D.assert_replicas_equal(drift, "dp")
    out["drift_ok"], out["drift_div"] = _np(ok), _np(div)
    out["digest_drift"] = np.array(D._fingerprint(drift)[0], np.int64)
    perm = torch.arange(32, dtype=torch.float32)
    if rank == 1:
        perm = perm.flip(0)
    out["perm_ok"] = _np(D.assert_replicas_equal({"x": perm}, "dp")[0])
    mon = D.DivergenceMonitor(every=2)
    state = mon.init()
    for _ in range(4):
        state = mon.update(state, tree, "dp")
    out["mon_checks"] = _np(state.checks)
    out["mon_clean"] = _np(state.diverged)
    poisoned = {"a": _t(inp["div_a"]).clone(), "b": _t(inp["div_b"])}
    if rank == 2:
        poisoned["a"][0, 0] += 0.5
    for _ in range(2):
        state = mon.update(state, poisoned, "dp")
    out["mon_poisoned"] = _np(state.diverged)
    out["mon_max"] = _np(state.max_divergence)
    for _ in range(2):
        state = mon.update(state, tree, "dp")
    out["mon_latched"] = _np(state.diverged)
    forced = mon.update(mon.init(), tree, "dp",
                        force=torch.tensor(int(rank == 1)))
    out["mon_forced_checks"] = _np(forced.checks)
    return out


def _lin_loss(w, x, y):
    return ((x @ w - y) ** 2).mean()


def _local_grads(loss, params, *args):
    """This rank's grads of ``loss(params, *args)`` (a dict of tensors)."""
    import torch

    from apex_tpu_torch import _tree

    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    grads = torch.autograd.grad(loss(live, *args), _tree.leaves(live))
    return _tree.unflatten(_tree.paths(params), list(grads))


def suite_ddp(rank, n, inp, directory):
    """DDP, the sync family and the overlap engine on 2 ranks."""
    import torch

    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        Reducer,
        average_reduced,
        overlapped_value_and_grad,
        plan_overlap,
        sync_autodiff_gradients,
        sync_gradients,
        sync_gradients_bucketed,
        sync_gradients_flat,
        sync_gradients_overlapped,
    )
    out = {}
    rows = slice(rank * 8, rank * 8 + 8)
    w = {"w": _t(inp["lin_w"])}
    x, y = _t(inp["lin_x"][rows]), _t(inp["lin_y"][rows])
    g = _local_grads(lambda p, x, y: _lin_loss(p["w"], x, y), w, x, y)
    summed = sync_gradients(g, "data", gradient_average=False)
    out["avg_reduced"] = _np(average_reduced(summed, "data")["w"])
    out["synced"] = _np(sync_gradients(g, "data")["w"])
    out["synced_flat"] = _np(sync_gradients_flat(g, "data")["w"])
    out["noavg"] = _np(sync_gradients(
        {"g": _t(inp["ones"][rank])}, "data", gradient_average=False)["g"])
    for pre in (1.0, 4.0):
        out[f"pre{pre}"] = _np(sync_gradients(
            {"g": _t(inp["pre_x"][rank])}, "data",
            gradient_predivide_factor=pre)["g"])
    pg = {"w": _t(inp["par_w"][rank]), "b": _t(inp["par_b"][rank])}
    for pre in (1.0, 4.0, 0.5):
        paths = {"plain": sync_gradients(pg, "data",
                                         gradient_predivide_factor=pre),
                 "flat": sync_gradients_flat(pg, "data",
                                             gradient_predivide_factor=pre),
                 "bucketed": sync_gradients_bucketed(
                     pg, "data", bucket_cap_mb=0.0002,
                     gradient_predivide_factor=pre)}
        for name, res in paths.items():
            for k in pg:
                out[f"par_{name}_{pre}_{k}"] = _np(res[k])
    gx = {"g": _t(inp["ddp_x"][rank])}
    ddp = DistributedDataParallel(axis_name="data")
    delayed = DistributedDataParallel(axis_name="data", delay_allreduce=True)
    out["ddp_synced"] = _np(ddp.sync(gx)["g"])
    out["ddp_kept"] = _np(delayed.sync(gx)["g"])
    out["ddp_forced"] = _np(delayed.allreduce(gx)["g"])
    fp32 = DistributedDataParallel(axis_name="data",
                                   allreduce_always_fp32=True)
    res = fp32.sync({"g": _t(inp["ddp_x"][rank]).to(torch.bfloat16)})["g"]
    out["fp32_dtype_bf16"] = np.array(res.dtype == torch.bfloat16)
    out["fp32_bits"] = _np(res)
    out["reducer"] = _np(Reducer(axis_name="data").reduce(
        {"p": torch.tensor([float(rank)])})["p"])
    # the reference's mixed custom_vjp tree: here every leaf is local
    mp = {"plain": _t(inp["mix_plain"]), "cvjp": _t(inp["mix_cvjp"])}
    xm = _t(inp["mix_x"][rank * 8:rank * 8 + 8])

    def mix_loss(p, x):
        return ((x * p["plain"]) ** 2 + (x * p["cvjp"]) ** 2).mean()

    out.update({f"mix_{k}": _np(v) for k, v in sync_autodiff_gradients(
        _local_grads(mix_loss, mp, xm), "data").items()})
    out.update({f"ddp_avg_{k}": _np(v) for k, v in ddp.average_reduced(
        _local_grads(mix_loss, mp, xm)).items()})
    # the overlap engine
    og = {k: _t(inp[f"ov_{k}"][rank]) for k in ("a", "b", "c")}
    for pre, avg in ((1.0, True), (4.0, True), (1.0, False)):
        ref = sync_gradients(og, "dp", gradient_average=avg,
                             gradient_predivide_factor=pre)
        ov = sync_gradients_overlapped(
            og, "dp", gradient_average=avg, gradient_predivide_factor=pre,
            bucket_cap_mb=0.0005)
        for k in og:
            out[f"ov_ref_{pre}_{avg}_{k}"] = _np(ref[k])
            out[f"ov_{pre}_{avg}_{k}"] = _np(ov[k])
    one = sync_gradients_overlapped(og, "dp", bucket_cap_mb=100.0)
    out.update({f"ov_one_{k}": _np(v) for k, v in one.items()})
    out["ov_plan_mismatch"] = np.array(_error(lambda: (
        sync_gradients_overlapped(
            {"a": torch.zeros(4), "b": torch.zeros(2)}, "dp",
            plan=plan_overlap({"a": torch.zeros(4)})))))
    params = {k: _t(inp[f"mlp_{k}"]) for k in ("w1", "w2", "b")}
    xs = _t(inp["mlp_x"][rank * 16:rank * 16 + 16])
    ys = _t(inp["mlp_y"][rank * 16:rank * 16 + 16])

    def mlp_loss(p, x, y):
        h = torch.tanh(x @ p["w1"])
        return ((h @ p["w2"] + p["b"] - y) ** 2).mean()

    fn = overlapped_value_and_grad(mlp_loss, axis_name="dp",
                                   bucket_cap_mb=0.0005)
    loss, gov = fn(params, xs, ys)
    gref = sync_gradients(_local_grads(mlp_loss, params, xs, ys), "dp")
    out["vg_loss"] = _np(loss)
    for k in params:
        out[f"vg_{k}"] = _np(gov[k])
        out[f"vg_ref_{k}"] = _np(gref[k])
    plan = plan_overlap(params, 0.0005)
    order = [k for k, _, _ in fn.last_trace.issued]
    out["vg_issue_order"] = np.array(order)
    out["vg_bucket_leaves"] = np.array([b.indices[0] for b in plan.buckets])
    (_, aux), _ = overlapped_value_and_grad(
        lambda p, x, y: (mlp_loss(p, x, y), 7.0), axis_name="dp",
        has_aux=True)(params, xs, ys)
    out["vg_aux"] = np.array(aux)
    # a param the loss does not reach gets a zero gradient
    unused = dict(params, u=torch.ones(3))
    _, gu = overlapped_value_and_grad(mlp_loss, axis_name="dp",
                                      bucket_cap_mb=0.0005)(unused, xs, ys)
    out["vg_unused"] = _np(gu["u"])
    out["vg_unused_w1"] = _np(gu["w1"])
    plain = DistributedDataParallel(axis_name="dp", flat_buckets=False)
    over = DistributedDataParallel(axis_name="dp", overlap_buckets=True,
                                   bucket_cap_mb=0.0005)
    ox = {"g": _t(inp["ddp_x"][rank])}
    out["ddp_plain"] = _np(plain.sync(ox)["g"])
    out["ddp_over"] = _np(over.sync(ox)["g"])
    out["wrapped_call"] = _np(DistributedDataParallel(
        torch.nn.Linear(2, 1, bias=False).requires_grad_(False))(
        torch.ones(1, 2)) * 0)
    return out


def _zero_params(inp, dtype=None):
    return {k: _t(inp[f"zp_{k}"], dtype) for k in ("w", "b")}


def suite_zero1(rank, n, inp, directory):
    """ZeRO-1 on 2 ranks against synced grads + replicated flat Adam."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import Zero1FusedAdam, sync_gradients
    from apex_tpu_torch.resilience import (
        FaultPlan,
        Preempted,
        ResilientTrainLoop,
    )

    out = {}
    opt = Zero1FusedAdam(lr=1e-2, weight_decay=0.01, axis_name="dp",
                         bucket_cap_mb=0.0005)
    tx = fused_adam(lr=1e-2, weight_decay=0.01, flat=True)
    zp, rp = _zero_params(inp), _zero_params(inp)
    zs, rs = opt.init(zp), tx.init(rp)
    out["n_buckets"] = np.array(len(zs.mu))
    for step in range(3):
        gl = {k: _t(inp[f"zg{step}_{k}"][rank]) for k in ("w", "b")}
        zp, zs = opt.step(gl, zs, zp)
        upd, rs = tx.update(sync_gradients(gl, "dp"), rs, rp)
        for p, u in zip(_tree.leaves(rp), _tree.leaves(upd)):
            p.add_(u)
        for k in zp:
            out[f"z_{step}_{k}"] = _np(zp[k])
            out[f"r_{step}_{k}"] = _np(rp[k])
    out["z_count"], out["r_count"] = _np(zs.count), _np(rs.count)
    full = opt.gather_state(zs)
    mu_t, nu_t = opt.unpack_state(zp, full)
    for k in zp:
        out[f"zmu_{k}"], out[f"znu_{k}"] = _np(mu_t[k]), _np(nu_t[k])
    out["rmu"], out["rnu"] = _np(rs.mu["float32"]), _np(rs.nu["float32"])
    out["shard_mu0"] = _np(zs.mu[0])
    back = opt.shard_state(full)
    out["shard_roundtrip"] = np.array(all(
        torch.equal(a, b) for a, b in zip(back.mu + back.nu,
                                          zs.mu + zs.nu)))
    # the global layout saved by rank 0 under the reference's schema
    path = os.path.join(directory, "zero1_ckpt")
    if rank == 0:
        # leaf order: opt.count, opt.mu, opt.nu, params.b, params.w
        spec = opt.state_specs(zp)
        specs = [spec.count, *spec.mu, *spec.nu, (), ()]
        manager = ckpt.CheckpointManager(path, async_save=True)
        manager.save(3, {"params": zp, "opt": full}, specs=specs)
        manager.wait_until_finished()
    B.barrier("dp")
    schema = ckpt.read_manifest(os.path.join(path, "step_00000003"))[
        "state_schema"]
    out["ckpt_fingerprint"] = np.array(schema["fingerprint"])
    target = {"params": _zero_params(inp), "opt": opt.gather_state(
        opt.init(zp))}
    restored = ckpt.restore_checkpoint(path, target=target)
    again = opt.shard_state(restored["opt"])
    out["restored_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(again.mu + again.nu,
                                          zs.mu + zs.nu))
        and all(torch.equal(restored["params"][k], zp[k]) for k in zp))
    # bf16 params, fp32 grads: reduced in fp32, gathered in bf16
    bopt = Zero1FusedAdam(lr=1e-2, axis_name="dp")
    bp = {"w": _t(inp["bf_w"], torch.bfloat16)}
    bs = bopt.init(bp)
    bp, bs = bopt.step({"w": _t(inp["bf_g"][rank])}, bs, bp)
    out["bf_w"] = _np(bp["w"])
    out["bf_mu_dtype32"] = np.array(all(m.dtype == torch.float32
                                        for m in bs.mu))
    # the replicated path on bf16 grads sums them in bf16
    rp16 = {"w": _t(inp["bf_w"], torch.bfloat16)}
    rtx = fused_adam(lr=1e-2, flat=True)
    upd, _ = rtx.update(sync_gradients(
        {"w": _t(inp["bf_g"][rank]).to(torch.bfloat16)}, "dp"),
        rtx.init(rp16), rp16)
    rp16["w"].add_(upd["w"])
    out["bf_replicated_w"] = _np(rp16["w"])
    wrong = Zero1FusedAdam(axis_name="dp", num_shards=4)
    pw = {"w": torch.ones(32, 16)}
    out["mismatch"] = np.array(_error(lambda: wrong.step(
        {"w": torch.ones(32, 16)}, wrong.init(pw), pw)))
    # sharded state through ResilientTrainLoop, one directory a rank
    copt = Zero1FusedAdam(lr=5e-2, weight_decay=0.01, axis_name="dp",
                          bucket_cap_mb=0.0005)

    def chaos_init():
        params = _zero_params(inp)
        return {"params": params, "opt": copt.init(params)}

    def chaos_step(state, step):
        gen = np.random.default_rng([1000 + step, rank])
        # keys in sorted order: a restored tree's dicts come back sorted
        gl = {k: torch.from_numpy(gen.standard_normal(
            tuple(state["params"][k].shape)).astype(np.float32))
            for k in sorted(state["params"])}
        state["params"], state["opt"] = copt.step(gl, state["opt"],
                                                  state["params"])
        loss = sum(float((p.float() ** 2).sum())
                   for p in _tree.leaves(state["params"]))
        return state, {"loss": loss}

    base = os.path.join(directory, f"rank{rank}")
    clean = ResilientTrainLoop(chaos_step, directory=base + "/clean",
                               save_every=3).run(chaos_init(), 7)
    chaos = base + "/chaos"
    preempted = _error(lambda: ResilientTrainLoop(
        chaos_step, directory=chaos, save_every=3,
        fault_plan=FaultPlan.parse("preempt@4")).run(chaos_init(), 7))
    final = ResilientTrainLoop(
        chaos_step, directory=chaos, save_every=3,
        fault_plan=FaultPlan.parse("preempt@4")).run(chaos_init(), 7)
    out["preempted"] = np.array(preempted)
    out["preempt_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(clean),
                                          _tree.leaves(final))))
    out["preempt_count"] = _np(final["opt"].count)
    out["preempt_moved"] = np.array(all(float(m.abs().max()) > 0
                                        for m in final["opt"].mu))
    clean2 = ResilientTrainLoop(chaos_step, directory=base + "/clean2",
                                save_every=2).run(chaos_init(), 7)
    torn = base + "/torn"
    try:
        ResilientTrainLoop(
            chaos_step, directory=torn, save_every=2,
            fault_plan=FaultPlan.parse("preempt@5,ckpt_torn@5")).run(
            chaos_init(), 7)
        out["torn_preempted"] = np.array(False)
    except Preempted as exc:
        out["torn_preempted"] = np.array(exc.checkpoint_path is None)
    loop2 = ResilientTrainLoop(chaos_step, directory=torn, save_every=2,
                               fault_plan=FaultPlan.parse("ckpt_torn@5"))
    final2 = loop2.run(chaos_init(), 7)
    out["torn_resumed_from"] = np.array(loop2.resumed_from)
    out["torn_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(clean2),
                                          _tree.leaves(final2))))
    return out


def suite_syncbn(rank, n, inp, directory):
    """SyncBatchNorm on 4 ranks."""
    import torch

    from apex_tpu_torch.parallel import (
        SyncBatchNorm,
        create_syncbn_process_group,
    )

    out = {}

    def rows(name, k):
        return _t(inp[name][rank * k:(rank + 1) * k])

    bn = SyncBatchNorm(6, device="cpu")
    out["global"] = _np(bn(rows("g_x", 4)).detach())
    bn1 = SyncBatchNorm(4, device="cpu", momentum=1.0)
    bn1(rows("rs_x", 4))
    out["rs_mean"], out["rs_var"] = (_np(bn1.running_mean),
                                     _np(bn1.running_var))
    wf = SyncBatchNorm(4, device="cpu", affine=False)
    out["welford"] = _np(wf(rows("wf_x", 16)))
    group = create_syncbn_process_group(2, axis_name="data")
    out["group"] = np.array(str(group))
    gb = SyncBatchNorm(6, device="cpu", affine=False, process_group=group)
    out["grouped"] = _np(gb(rows("gs_x", 4)))
    out["group3"] = np.array(_error(
        lambda: SyncBatchNorm(6, device="cpu", affine=False, group_size=3)(
            rows("gs_x", 4))))
    out["whole"] = np.array(str(create_syncbn_process_group(4)))
    # the backward through the statistics' all-reduces
    bw = SyncBatchNorm(6, device="cpu")
    with torch.no_grad():
        bw.weight.copy_(_t(inp["bw_w"]))
        bw.bias.copy_(_t(inp["bw_b"]))
    xb = rows("bw_x", 4).requires_grad_()
    (bw(xb) * rows("bw_dy", 4)).sum().backward()
    out["bw_dx"], out["bw_dw"], out["bw_db"] = (
        _np(xb.grad), _np(bw.weight.grad), _np(bw.bias.grad))
    gw = SyncBatchNorm(6, device="cpu", affine=False, process_group=group)
    xg = rows("gs_x", 4).requires_grad_()
    (gw(xg) * rows("bw_dy", 4)).sum().backward()
    out["grouped_dx"] = _np(xg.grad)
    return out


def suite_amp(rank, n, inp, directory):
    """amp's votes across 2 ranks: the overflow skip and the fp8 amax."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.scaler import Fp8DelayedScaler, LossScaler
    from apex_tpu_torch.optimizers import fused_adam

    out = {}
    tx = fused_adam(lr=1e-2, flat=True)
    scaler = LossScaler("dynamic", init_scale=2.0 ** 10)
    params = {"w": _t(inp["amp_w"])}
    opt_state, sstate = tx.init(params), scaler.init()
    for step in range(3):
        grads = {"w": _t(inp[f"amp_g{step}"][rank])}
        upd, opt_state, sstate, ovf = amp.scaled_update(
            tx, scaler, grads, opt_state, params, sstate,
            overflow_reduce_axes=("dp",))
        params["w"].add_(upd["w"])
        out[f"amp_ovf{step}"] = _np(ovf)
        out[f"amp_w{step}"] = _np(params["w"])
        out[f"amp_scale{step}"] = _np(sstate.loss_scale)
    out["amp_count"] = _np(opt_state.count)

    class Observed:
        def __init__(self, fwd, grad):
            self.fwd, self.grad = fwd, grad

        def fwd_amax(self):
            return torch.from_numpy(self.fwd)

        def grad_amax(self):
            return torch.from_numpy(self.grad)

    fp8 = Fp8DelayedScaler(["s", "t"], history=4)
    state = fp8.init(device="cpu")
    for step in range(3):
        state = fp8.update(state, Observed(inp[f"fp8_fwd{step}"][rank],
                                           inp[f"fp8_grad{step}"][rank]),
                           reduce_axes=("dp",))
    d = fp8.state_dict(state)
    out["fp8_fwd_ring"] = np.array(d["fwd"]["ring"], np.float32)
    out["fp8_grad_ring"] = np.array(d["grad"]["ring"], np.float32)
    out["fp8_scales_fwd"], out["fp8_scales_grad"] = (
        _np(s) for s in fp8.scales(state))
    return out


def suite_multiproc(rank, n, inp, directory):
    """What the launcher gave this rank (run through it)."""
    import torch

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    again = initialize_distributed()  # idempotent
    x = torch.tensor([float(rank)])
    return {"env": np.array([int(os.environ[k]) for k in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")]),
            "again": np.array(again[:2]), "device": np.array(str(again[2])),
            "sum": _np(B.all_reduce(x, group="dp"))}


def suite_train(rank, n, inp, directory):
    """A train loop across the launcher's processes (ref
    ``test_multiproc.py:197``): fused Adam on grads mean-reduced over the
    ranks, the params checked bit-identical on every rank each step."""
    import torch

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.distributed.divergence import replica_divergence
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import sync_autodiff_gradients

    tx = fused_adam(lr=5e-2)
    rows = slice(rank * 32 // n, (rank + 1) * 32 // n)
    x, y = _t(inp["tr_x"][rows]), _t(inp["tr_y"][rows])
    params = {"w": torch.zeros(8, 1)}
    state = tx.init(params)
    losses, divs = [], []
    for _ in range(30):
        live = {"w": params["w"].detach().requires_grad_()}
        loss = ((x @ live["w"] - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [live["w"]])
        g = sync_autodiff_gradients({"w": g}, "dp")
        upd, state = tx.update(g, state, params)
        params["w"].add_(upd["w"])
        losses.append(float(B.all_reduce(loss.detach(), B.ReduceOp.AVG)))
        divs.append(float(replica_divergence(params, "dp")))
    return {"losses": np.array(losses, np.float32),
            "divs": np.array(divs, np.float32), "w": _np(params["w"])}


def suite_cuda(rank, n, inp, directory):
    """ZeRO-1 and DDP on CUDA tensors, the ranks sharing one GPU over
    gloo: the flat Adam kernel's launches and bit parity."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.distributed.divergence import replica_divergence
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import Zero1FusedAdam, sync_gradients

    device = torch.device("cuda", torch.cuda.current_device())
    opt = Zero1FusedAdam(lr=1e-2, weight_decay=0.01, axis_name="dp",
                         bucket_cap_mb=0.0005)
    tx = fused_adam(lr=1e-2, weight_decay=0.01, flat=True)
    zp = {k: v.to(device) for k, v in _zero_params(inp).items()}
    rp = {k: v.to(device) for k, v in _zero_params(inp).items()}
    zs, rs = opt.init(zp), tx.init(rp)
    launches, equal = 0, True
    for step in range(3):
        gl = {k: _t(inp[f"zg{step}_{k}"][rank]).to(device)
              for k in ("w", "b")}
        before = fak.launches
        zp, zs = opt.step(gl, zs, zp)
        launches += fak.launches - before
        upd, rs = tx.update(sync_gradients(gl, "dp"), rs, rp)
        for p, u in zip(_tree.leaves(rp), _tree.leaves(upd)):
            p.add_(u)
        equal = equal and all(torch.equal(zp[k], rp[k]) for k in zp)
    torch.cuda.synchronize()
    return {"launches": np.array(launches),
            "buckets": np.array(len(zs.mu)), "equal": np.array(equal),
            "device": np.array(str(zs.mu[0].device)),
            "divergence": _np(replica_divergence(zp, "dp"))}


def _flat_tree(prefix, tree, out):
    """``tree``'s tensors into ``out`` under ``prefix/key/...`` names."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat_tree(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = _np(v)


def suite_resnet(rank, n, inp, directory):
    """``resnet.tiny(sync_bn=True)`` on this rank's rows: the train-mode
    logits, the new batch stats and the local grads of the mean CE; then
    the imagenet example's DDP step (O0) at the same params and its
    synced fp32 grads (tests/test_torch_resnet.py)."""
    import torch

    from apex_tpu_torch import _tree, amp
    from apex_tpu_torch.examples.imagenet_resnet50 import (
        DataParallelResNetStep,
        cross_entropy,
    )
    from apex_tpu_torch.models import resnet
    from apex_tpu_torch.optimizers import fused_sgd

    model = resnet.tiny(sync_bn=True)
    variables = resnet.init_variables(torch.Generator().manual_seed(3),
                                      model, device="cpu")
    rows = inp["x"].shape[0] // n
    x = _t(inp["x"][rank * rows:(rank + 1) * rows])
    y = _t(inp["y"][rank * rows:(rank + 1) * rows]).long()
    out = {}
    live = _tree.map_leaves(lambda p: p.clone().requires_grad_(),
                            variables["params"])
    logits, stats = model.apply({"params": live,
                                 "batch_stats": variables["batch_stats"]},
                                x, train=True)
    grads = torch.autograd.grad(cross_entropy(logits, y),
                                _tree.leaves(live))
    out["logits"] = _np(logits)
    _flat_tree("stats", stats, out)
    _flat_tree("grads", _tree.unflatten(_tree.paths(live), list(grads)),
               out)
    handle = amp.initialize(None, opt_level="O0", verbosity=0)
    step = DataParallelResNetStep(model, handle, fused_sgd(lr=0.1))
    synced, loss, _ = step.grads(variables["params"],
                                 variables["batch_stats"], x, y,
                                 handle.scaler_state)
    _flat_tree("synced", synced, out)
    out["loss"] = _np(loss)
    return out


def suite_bert_train(rank, n, inp, directory):
    """The bert_train example's data-parallel gradients of its first
    global batch on this rank's rows (tests/test_torch_baseline_
    examples.py)."""
    import torch

    from apex_tpu_torch.examples import bert_train as ex
    from apex_tpu_torch.models import bert

    cfg = ex.tiny_config(layers=2, seq=int(inp["seq"]))
    params = bert.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = ex.make_batch(0, cfg, int(inp["rows"]), int(inp["seq"]))
    loss, grads = ex.grads(params, tuple(ex.rank_rows(t) for t in batch),
                           cfg)
    out = {"loss": _np(loss)}
    _flat_tree("grads", grads, out)
    return out


FLEET_DELAY_S = 0.2   # rank 1's host sleep before each probed sync
FLEET_ROUNDS = 3


def suite_fleet(rank, n, inp, directory):
    """The fleet tier on 4 ranks: fingerprints, the grad-sync probe with
    rank 1 delayed, the flight records, and the desync detector under
    ResilientTrainLoop with one element of rank 1's params perturbed."""
    import time

    import torch

    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.observability import fleet
    from apex_tpu_torch.observability.fleet import probe
    from apex_tpu_torch.parallel import sync_gradients_flat
    from apex_tpu_torch.resilience import ResilientTrainLoop, TrainAborted

    out = {}
    tree = {"b": _t(inp["fp_b"][rank]), "a": {"w": _t(inp["fp_a"][rank])}}
    out["gather"] = _np(fleet.fingerprint_gather(tree, "dp"))
    same = {"w": _t(inp["fp_a"][0])}
    out["delta_same"] = _np(fleet.fingerprint_delta(same, "dp"))
    drift = {"w": _t(inp["fp_a"][0]).clone()}
    if rank == 1:
        drift["w"][0, 0] += 1e-3
    out["delta_drift"] = _np(fleet.fingerprint_delta(drift, "dp"))

    # the probe: off, then on around the same sync, results bit for bit
    reg = obs.MetricRegistry()
    prev = obs.set_registry(reg)
    try:
        grads = {"g1": _t(inp["g1"][rank]), "g2": _t(inp["g2"][rank])}
        probe.reset()
        probe.disable()
        off = sync_gradients_flat(grads, "data")
        probe.enable()
        for _ in range(FLEET_ROUNDS):
            if rank == 1:
                time.sleep(FLEET_DELAY_S)
            on = sync_gradients_flat(grads, "data")
        out["probe_equal"] = np.array(all(
            torch.equal(off[k], on[k]) for k in off))
        waits = probe.wait_times()
        out["wait_sites"] = np.array(sorted(s for s, _ in waits))
        out["wait_s"] = np.array([waits[k] for k in sorted(waits)])
        out["last_collective"] = np.array(probe.last_collective())
        reg.dump(str(directory / "metrics.jsonl"))
        rec = obs.FlightRecorder(directory=str(directory), registry=reg,
                                 signals=())
        out["flightrec"] = np.array(rec.dump("fleet probe", kind="manual"))
    finally:
        probe.reset()
        obs.set_registry(prev)

    # the desync detector under the loop: healthy, then perturbed
    def run(perturb_at):
        params = {"w": _t(inp["fp_a"][0]).clone(),
                  "b": _t(inp["fp_b"][0]).clone()}
        detector = fleet.DesyncDetector.for_tree(params,
                                                 registry=obs.MetricRegistry())

        def step(state, i):
            state = {k: v * 0.5 + 0.25 for k, v in state.items()}
            if rank == 1 and i == perturb_at:
                state["w"][3, 5] += 1e-3
            return state, {"loss": float(state["w"].sum()),
                           "fleet_fingerprint":
                               fleet.fingerprint_gather(state, "dp")}

        loop = ResilientTrainLoop(step, max_rollbacks=0,
                                  desync_detector=detector,
                                  registry=obs.MetricRegistry())
        try:
            loop.run(params, 4)
        except TrainAborted as exc:
            return detector, exc.report.get("fleet")
        return detector, None

    healthy, verdict = run(perturb_at=None)
    out["healthy_verdicts"] = np.array(len(healthy.verdicts))
    out["healthy_aborted"] = np.array(verdict is not None)
    _, verdict = run(perturb_at=2)
    out["verdict"] = np.array(json.dumps(verdict, sort_keys=True))
    return out


SUITES = {"backend": suite_backend, "ddp": suite_ddp,
          "zero1": suite_zero1, "syncbn": suite_syncbn, "amp": suite_amp,
          "multiproc": suite_multiproc, "train": suite_train,
          "cuda": suite_cuda, "resnet": suite_resnet,
          "bert_train": suite_bert_train, "fleet": suite_fleet}


def main(argv) -> int:
    """``SUITE DIR``: run one suite on this rank (``RANK`` and
    ``WORLD_SIZE`` from the environment), saving ``DIR/rank<r>.npz``."""
    import torch

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    torch.set_num_threads(1)
    suite, directory = argv[0], Path(argv[1])
    launched = "MASTER_PORT" in os.environ
    rank, n, _ = initialize_distributed(
        backend="gloo", cpu=os.environ.get("APEX_TPU_TORCH_CPU", "1") == "1",
        init_method=None if launched else
        f"file://{directory / 'store'}",
        world_size=None if launched else int(os.environ["WORLD_SIZE"]),
        rank=None if launched else int(os.environ["RANK"]))
    with np.load(directory / "inputs.npz") as f:
        inputs = {k: f[k] for k in f.files}
    if suite not in SUITES:  # the Megatron, cp/ep/tp, examples' and
        # contrib suites
        from torch_contrib_suites import SUITES as contrib
        from torch_cp_suites import SUITES as cp_ep_tp
        from torch_example_suites import SUITES as examples
        from torch_megatron_suites import SUITES as megatron

        SUITES.update(megatron)
        SUITES.update(cp_ep_tp)
        SUITES.update(examples)
        SUITES.update(contrib)
    out = SUITES[suite](rank, n, inputs, directory)
    np.savez(directory / f"rank{rank}.npz", **out)
    B.barrier("dp")
    B.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
