"""The port's launcher (``python -m apex_tpu_torch.parallel.multiproc``)
on the CPU: ranks as processes over gloo, the environment each gets, a
failing rank failing the launch, no silent CPU run, and a training loop
across the processes held against the JAX package's under
``shard_map`` over 2 simulated devices (``tests/distributed/
test_multiproc.py``).

Tolerance of the training loop: 30 Adam steps of a linear regression on
both sides from the same numpy data; the losses and final weights agree
to 1e-4 relative (a few fp32 ulps a step, from two autograds, carried
through the trajectory; the loss falls by more than 10x either way).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.parallel import sync_autodiff_gradients as j_sync_autodiff
from apex_tpu_torch.parallel import multiproc

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_dist_worker.py")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1",
        **extra)
    return env


def _launch(args, timeout=240, **env):
    return subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=_env(**env))


def _results(directory, n):
    out = []
    for r in range(n):
        with np.load(Path(directory) / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def test_launcher_two_processes(tmp_path):
    """Each rank gets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and a
    rendezvous; a collective crosses the process boundary."""
    np.savez(tmp_path / "inputs.npz")
    proc = _launch(["--nprocs", "2", "--backend", "gloo", "--cpu", WORKER,
                    "multiproc", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r, res in enumerate(_results(tmp_path, 2)):
        assert res["env"].tolist() == [r, 2, r, 2]
        assert res["again"].tolist() == [r, 2]
        assert str(res["device"]) == "cpu"
        assert float(res["sum"][0]) == 1.0


def test_a_failing_rank_fails_the_launch(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text("import os, sys\n"
                      "sys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    proc = _launch(["--nprocs", "2", "--backend", "gloo", "--cpu",
                    str(script)])
    assert proc.returncode == 3, proc.stderr[-3000:]


def test_no_silent_cpu_run(monkeypatch, capsys):
    """Without --cpu a rank needs a GPU and raises where there is none;
    --cpu with NCCL is refused; a launch with no script prints usage."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multiproc.initialize_distributed(backend="gloo", cpu=False)
    with pytest.raises(ValueError, match="needs backend 'gloo'"):
        multiproc.initialize_distributed(backend="nccl", cpu=True)
    assert multiproc.main(["--nprocs", "2"]) == 1
    assert "usage" in capsys.readouterr().err
    assert multiproc.main(["--bogus", "x.py"]) == 2


def _train_inputs():
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((8, 1)).astype(np.float32)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    return {"tr_x": x, "tr_y": (x @ w_true).astype(np.float32)}


def test_training_across_processes_matches_reference(tmp_path):
    inputs = _train_inputs()
    np.savez(tmp_path / "inputs.npz", **inputs)
    proc = multiproc.run_simulated([WORKER, "train", str(tmp_path)], n=2,
                                   timeout=240, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = _results(tmp_path, 2)

    tx = jax_fused_adam(lr=5e-2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def step(params, opt_state, x, y):
        def loss_fn(p):
            return jnp.mean((x @ p["w"] - y) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        g = j_sync_autodiff(g, axis_name="dp")
        u, opt_state = tx.update(g, opt_state, params)
        return (optax.apply_updates(params, u), opt_state,
                jax.lax.pmean(loss, "dp"))

    jstep = jax.jit(shard_map(step, mesh=mesh,
                              in_specs=(P(), P(), P("dp"), P("dp")),
                              out_specs=(P(), P(), P())))
    params = {"w": jnp.zeros((8, 1))}
    opt_state = tx.init(params)
    x, y = jnp.asarray(inputs["tr_x"]), jnp.asarray(inputs["tr_y"])
    losses = []
    for _ in range(30):
        params, opt_state, loss = jstep(params, opt_state, x, y)
        losses.append(float(loss))
    for res in ranks:
        assert res["losses"][-1] < 0.1 * res["losses"][0]
        assert np.all(res["divs"] == 0.0)  # bit-identical replicas
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(res["w"], np.asarray(params["w"]),
                                   rtol=1e-4, atol=1e-6)
