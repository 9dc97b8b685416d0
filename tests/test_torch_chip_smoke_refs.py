"""The fp32 references of ``chip_smoke.py``'s GPT-2 and BERT gradient
checks write the attention and the MLP out with plain torch ops, apart
from the model code they check. Here, on the CPU at tiny() in fp32, each
must give the model's loss and gradients (both sides take the kernels'
plain versions on the CPU and differ only in the order of their sums):
the loss to LOSS_RTOL = 1e-5, every gradient leaf to GRAD_ATOL/GRAD_RTOL
= 1e-4.
"""

import importlib.util
import pathlib

import pytest
import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.models import bert, gpt2

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
B, S = 2, 16


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(family, smoke):
    gen = torch.Generator().manual_seed(0)
    if family == "gpt2":
        cfg = gpt2.tiny()
        params = gpt2.init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        batch = (tokens, torch.roll(tokens, -1, dims=-1))
        return (params,
                lambda t: gpt2.loss_fn(t, batch, cfg, remat=True,
                                       vocab_chunks=4),
                lambda t: smoke.gpt2_plain_loss(t, batch, cfg))
    cfg = bert.tiny()
    params = bert.init_params(gen, cfg, device="cpu")
    targets = torch.randint(4, cfg.vocab_size, (B, S), generator=gen)
    pad = torch.zeros(B, S, dtype=torch.bool)
    pad[1, 11:] = True
    mlm = (torch.rand(B, S, generator=gen) < 0.3) & ~pad
    mlm[0, 0] = True
    inputs = torch.where(mlm, 3, torch.where(pad, 0, targets))
    batch = (inputs, targets, mlm.float())
    return (params,
            lambda t: bert.loss_fn(t, batch, cfg, pad_mask=pad, remat=True),
            lambda t: smoke.bert_plain_loss(t, batch, cfg, pad))


def _loss_and_grads(loss_of, params):
    live = _tree.map_leaves(lambda t: t.detach().requires_grad_(), params)
    loss = loss_of(live)
    return loss.detach(), torch.autograd.grad(loss, _tree.leaves(live))


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_reference_matches_the_model(family, smoke):
    params, model_loss, ref_loss = _case(family, smoke)
    loss, grads = _loss_and_grads(model_loss, params)
    ref, ref_grads = _loss_and_grads(ref_loss, params)
    torch.testing.assert_close(ref, loss, rtol=LOSS_RTOL, atol=0)
    for path, g, r in zip(_tree.paths(params), grads, ref_grads):
        torch.testing.assert_close(r, g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda m: f"{path}: {m}")

