"""The port's BASELINE examples on gloo CPU ranks, through the launcher
(``python -m apex_tpu_torch.parallel.multiproc --cpu``):

- ``imagenet_resnet50 --smoke`` on 2 ranks (DDP + SyncBatchNorm, amp O2,
  ``fused_sgd``): the loss falls, validation prints top-1/top-5, a
  checkpoint resumes with ``--resume auto`` and evaluates with
  ``--evaluate``; and ``--no-sync-bn``. (Its step against one device's
  autograd of the global batch: ``tests/test_torch_resnet.py``.)
- ``simple_distributed`` on 2 ranks: both of its ``OK`` checks.
- ``bert_train`` on 2 ranks: its gradients equal one device's autograd
  of ``bert.loss_fn`` over the global batch (elementwise, rtol 1e-5 with
  a floor of 1e-5 times the largest gradient: fp32 sums in another
  order); its checkpoint resumes with ``--resume``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch import _tree
from torch_dist_worker import run_ranks

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "apex_tpu_torch" / "examples"


def _launch(script, *args, n=2, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", str(n), "--backend", "gloo", "--cpu",
         str(EXAMPLES / script), *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_imagenet_smoke_checkpoint_resume_evaluate(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _launch("imagenet_resnet50.py", "--smoke", "--checkpoint-dir",
                  ckpt)
    assert "(decreased)" in out and "val: top1" in out
    assert "=> saved epoch 0 (new best)" in out
    assert out.count("val: top1") == 1  # rank 0 alone prints
    out = _launch("imagenet_resnet50.py", "--smoke", "--checkpoint-dir",
                  ckpt, "--resume", "auto", "--evaluate")
    assert f"=> resumed from '{ckpt}' (epoch 0" in out
    assert "val: top1" in out and "loss" not in out


def test_imagenet_smoke_without_sync_bn():
    out = _launch("imagenet_resnet50.py", "--smoke", "--no-sync-bn")
    assert "(decreased)" in out and "val: top1" in out


def test_simple_distributed_checks():
    out = _launch("simple_distributed.py")
    assert "DDP grad == global-batch grad: OK" in out
    assert "converged: OK" in out


def test_bert_train_gradients_are_the_global_batch(tmp_path):
    """15% masking leaves the ranks different numbers of masked
    positions: each rank's loss is weighted by its share, so the mean
    over the ranks is the global batch's gradient, not the mean of the
    ranks' means."""
    from apex_tpu_torch.examples import bert_train as ex
    from apex_tpu_torch.models import bert

    rows, seq = 4, 16
    ranks = run_ranks("bert_train", 2, tmp_path,
                      {"rows": np.array(rows), "seq": np.array(seq)})
    cfg = ex.tiny_config(layers=2, seq=seq)
    params = bert.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    tokens, targets, mask = ex.make_batch(0, cfg, rows, seq)
    assert mask[:2].sum() != mask[2:].sum()
    live = _tree.map_leaves(lambda p: p.clone().requires_grad_(), params)
    loss = bert.loss_fn(live, (tokens, targets, mask), cfg, remat=False,
                        tp_axis=None)
    want = torch.autograd.grad(loss, _tree.leaves(live))
    loss = float(loss.detach())
    scale = max(float(g.abs().max()) for g in want)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        for path, w in zip(_tree.paths(params), want):
            np.testing.assert_allclose(
                r["grads/" + "/".join(path)], w.numpy(), rtol=1e-5,
                atol=1e-5 * scale, err_msg=str(path))


def test_bert_train_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _launch("bert_train.py", "--dp", "2", "--steps", "2", "--seq",
                  "16", "--checkpoint-dir", ckpt, "--save-every", "1")
    assert "dp=2 FusedLAMB: loss" in out
    out = _launch("bert_train.py", "--dp", "2", "--steps", "3", "--seq",
                  "16", "--checkpoint-dir", ckpt, "--resume")
    assert "=> resumed from step 1" in out and "step   2" in out
    assert "step   0" not in out
