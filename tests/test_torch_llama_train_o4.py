"""The 3-D example's O4 tier and its checkpoint and resume path
(``apex_tpu_torch.examples.llama_train``), on 4 gloo CPU ranks
(``torch_example_suites.py::suite_llama_o4``).

The oracle is the port's own single-device O4 step on the same global
batch (one ``Fp8DelayedScaler(["lm_head"])`` over ``llama.loss_fn``),
not the JAX package's 3-D example: that example aborts at step 0 at
``--opt-level O4`` under jax 0.9 (the custom VJP of its fp8 product
returns the grad probe's cotangent varying over the mesh while the probe
itself is not, ``apex_tpu/ops/precision.py:134``), so it cannot be run.
The port's single-device O4 step is itself held against the JAX
package's by ``test_torch_amp_fp8.py``.

With the example's rules (the lm head folded into one call on the last
stage, the earlier stages voting 0, the observations voted MAX over pp,
dp and tp, each dp rank's loss its mean divided by dp) the 3-D rings are
the single-device rings on the global batch: dp's MAX is the global
batch's, tp's MAX over the weight and cotangent shards the whole
tensor's, and the gathered input is the same on every tp rank.

Tolerances: the rings within RING_RTOL = 1e-4 (a forward amax is the max
of the same fp32 values reached by another order of sums, the weight's
exactly; a cotangent amax the max of fp32 cotangents); at step 0 every
rank's scales are 1, at step 1 the single-device step runs under the
ranks' rings after step 0, so both steps cast under the same scales. The
losses within 1e-5 relative; each gradient block within GRAD_REL = 1e-3
in relative L2 (the fp8 casts round the same values, the products sum
fp8 values in fp32 in another order, and a cotangent within an fp32
rounding of an E5M2 tie casts one ulp away); each single-device step
starts from the params the ranks started it from, put together from
their shards, as Adam turns a gradient's rounding into a larger update
difference. The resumed run's SHA-1
(shards, Adam moments and count, fp8 rings) equals the uninterrupted
run's exactly.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.amp import Fp8DelayedScaler
from apex_tpu_torch.examples import llama_train as ex
from apex_tpu_torch.examples._common import block
from apex_tpu_torch.models import llama
from torch_dist_worker import run_ranks
from torch_example_suites import (
    O4_GRIDS,
    O4_M,
    O4_MB,
    O4_SEQ,
    O4_STEPS,
    RESUME_STEPS,
)

RING_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("llama_o4", 4, tmp_path_factory.mktemp("llama_o4"), {},
                     timeout=400)


def _coords(r, tag, tp, pp):
    pp_r, _, tp_r = (int(c) for c in r[f"{tag}_coords"])
    return {"pp": (pp_r, pp), "tp": (tp_r, tp)}


def _gathered(cfg, tag, tp, pp, it, ranks):
    """The full params the ranks started step ``it`` from, put together
    from their shards."""
    full = llama.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    sspec, ispec = ex.stage_specs(cfg), ex.io_specs(cfg)
    for r in ranks:
        coords = _coords(r, tag, tp, pp)
        for k, v in full["layers"].items():
            block(v.view(pp, -1, *v.shape[1:]), sspec[k], coords)[0].copy_(
                torch.from_numpy(r[f"{tag}_p{it}_{k}"]))
        for k in ispec:
            block(full[k], ispec[k], coords).copy_(
                torch.from_numpy(r[f"{tag}_p{it}_{k}"]))
    return full


def _single_device(tag, tp, pp, ranks):
    """The single-device O4 steps on the global batch, each from the
    params the ranks started it from: each step's loss, grads and rings,
    step 1 under the ranks' rings after step 0."""
    dp = 4 // (tp * pp)
    cfg = ex.tiny_config(pp, tp, 1, O4_SEQ)
    fp8 = Fp8DelayedScaler(["lm_head"], history=ex.FP8_HISTORY)
    state = fp8.init("cpu")
    out = []
    for it in range(O4_STEPS):
        full = _gathered(cfg, tag, tp, pp, it, ranks)
        tokens, targets = ex.make_batch(it, cfg, O4_M, O4_MB * dp, O4_SEQ)
        batch = (tokens.reshape(-1, O4_SEQ), targets.reshape(-1, O4_SEQ))
        with fp8.step(state) as ctx:
            loss, grads = ctx.value_and_grad(
                lambda p: llama.loss_fn(p, batch, cfg, remat=False,
                                        tp_axis=None))(full)
        new = fp8.update(state, ctx)
        out.append((float(loss), grads, new))
        # the next step under the scales the ranks voted
        state = new._replace(
            fwd=new.fwd._replace(ring=torch.from_numpy(
                ranks[0][f"{tag}_fwd{it}"])),
            grad=new.grad._replace(ring=torch.from_numpy(
                ranks[0][f"{tag}_grad{it}"])))
    return cfg, out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("grid", O4_GRIDS, ids=[g[0] for g in O4_GRIDS])
def test_o4_rings_and_grads_match_single_device(ranks, grid):
    tag, tp, pp = grid
    cfg, single = _single_device(tag, tp, pp, ranks)
    sspec, ispec = ex.stage_specs(cfg), ex.io_specs(cfg)
    for it, (loss, grads, state) in enumerate(single):
        for r in ranks:
            # every rank holds the same rings, the single device's
            np.testing.assert_array_equal(r[f"{tag}_fwd{it}"],
                                          ranks[0][f"{tag}_fwd{it}"])
            np.testing.assert_array_equal(r[f"{tag}_grad{it}"],
                                          ranks[0][f"{tag}_grad{it}"])
            np.testing.assert_allclose(r[f"{tag}_loss{it}"], loss,
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(ranks[0][f"{tag}_fwd{it}"],
                                   state.fwd.ring.numpy(), rtol=RING_RTOL)
        np.testing.assert_allclose(ranks[0][f"{tag}_grad{it}"],
                                   state.grad.ring.numpy(), rtol=RING_RTOL)
        # the E5M2 ring is written: the probes' gradients reached it
        assert float(state.grad.ring[0, it]) > 0
        assert ranks[0][f"{tag}_grad{it}"][0, it] > 0
        for r in ranks:
            coords = _coords(r, tag, tp, pp)
            for k, g in grads["layers"].items():
                full = g.reshape(pp, -1, *g.shape[1:])
                want = block(full, sspec[k], coords)[0]
                rel = _rel(r[f"{tag}_g{it}_{k}"], want.numpy())
                assert rel <= GRAD_REL, (tag, it, k, rel)
            for k in ispec:
                want = block(grads[k], ispec[k], coords)
                rel = _rel(r[f"{tag}_g{it}_{k}"], want.numpy())
                assert rel <= GRAD_REL, (tag, it, k, rel)


@pytest.mark.parametrize("level", ["O0", "O4"])
def test_preempt_save_resume_reaches_the_uninterrupted_sha1(ranks, level):
    for r in ranks:
        assert int(r[f"{level}_preempted_at"]) == 1
        assert int(r[f"{level}_resumed_from"]) == 1
        assert r[f"{level}_resumed_steps"].tolist() == [RESUME_STEPS - 1]
        assert str(r[f"{level}_resume_log"]) == "=> resumed from step 1"
        assert str(r[f"{level}_sha_resumed"]) == str(
            r[f"{level}_sha_uninterrupted"])
        losses = r[f"{level}_losses"]
        assert len(losses) == RESUME_STEPS and np.isfinite(losses).all()
    # the stages' shards differ, so their states' digests do too
    assert len({str(r[f"{level}_sha_resumed"]) for r in ranks}) == 4
    if level == "O4":
        assert all(int(r["O4_fp8_steps"]) == RESUME_STEPS for r in ranks)


def test_o4_registers_the_lm_head_only():
    step_cls = ex.Megatron3D
    assert ex.FP8_SITES == ("lm_head",) and ex.FP8_HISTORY == 16
    with pytest.raises(ValueError, match="O0 or O4"):
        step_cls.__init__(object.__new__(step_cls), None, None, 1, 1, 2,
                          opt_level="O2")
    args = ex.parse_args(["--opt-level", "O4", "--checkpoint-dir", "d",
                          "--save-every", "2", "--resume"])
    assert (args.opt_level, args.checkpoint_dir, args.save_every,
            args.resume) == ("O4", "d", 2, True)
    assert ex.checkpoint_dir("d", 3).endswith("rank3")


def test_example_preempts_with_75_and_resumes(tmp_path):
    """The example through the launcher on 4 gloo ranks at O4: a fault
    plan's preemption after step 1 exits 75 with an emergency save in
    each rank's directory; the same command with ``--resume`` goes on
    from it to the last step."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
           "--nprocs", "4", "--backend", "gloo", "--cpu",
           str(root / "apex_tpu_torch" / "examples" / "llama_train.py"),
           "--pp", "2", "--dp", "1", "--tp", "2", "--steps", "3",
           "--layers-per-stage", "1", "--microbatches", "2", "--seq", "16",
           "--opt-level", "O4", "--checkpoint-dir", str(ckpt),
           "--save-every", "0"]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("APEX_TPU_FAULT_PLAN", None)
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           env=dict(env, APEX_TPU_FAULT_PLAN="preempt@1"),
                           cwd=root)
    assert first.returncode == 75, first.stdout[-2000:] + first.stderr[-2000:]
    assert "lm_head in fp8" in first.stdout and "step   1" in first.stdout
    for r in range(4):
        assert (ckpt / f"rank{r}" / "step_00000001").is_dir()
    second = subprocess.run(cmd + ["--resume"], capture_output=True,
                            text=True, timeout=300, env=env, cwd=root)
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[
        -2000:]
    assert "=> resumed from step 1" in second.stdout
    assert "step   2" in second.stdout and "step   0" not in second.stdout
