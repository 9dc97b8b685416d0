"""The memory knobs of the port's training losses, on the CPU:

- Llama's ``loss_fn(vocab_chunks=k)`` (the streamed lm head and CE of
  ``llama.py:412``) against JAX's, loss and every gradient leaf, dense
  and MoE (fp32, JAX's Pallas kernels in interpret mode; the tolerances
  of ``test_torch_training.py``);
- ``remat="dots"`` (a selective checkpoint keeping ``mm``/``addmm``
  outputs, JAX's ``dots_with_no_batch_dims_saveable``) gives the loss and
  grads of ``remat=False`` for Llama (dense and MoE), GPT-2 and BERT;
- under ``"dots"`` the backward runs no more ``aten.mm`` than with no
  recompute at all (the saved products are not run again), while full
  recompute (``remat=True``) runs the layers' products again; counted
  with a ``TorchDispatchMode``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu.models import llama as jax_llama
from apex_tpu.ops import pallas_config
from apex_tpu_torch import _tree
from apex_tpu_torch.models import bert, gpt2
from apex_tpu_torch.models import llama as port_llama
from test_torch_training import (
    GRAD_ATOL,
    GRAD_RTOL,
    _assert_tree_close,
    _port_batch,
    _port_params,
)

#: recompute reruns the same ops on the same values: equal up to the last
#: bits (the tolerance of test_torch_training.test_remat_equals_no_remat)
REMAT_ATOL, REMAT_RTOL = 1e-7, 1e-6


def _grads(loss_of, params):
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(live)
    return loss, list(torch.autograd.grad(loss, _tree.leaves(live)))


def _llama_case(num_experts: int):
    jcfg = jax_llama.tiny(num_experts=num_experts)
    jparams = jax_llama.init_params(jax.random.PRNGKey(5), jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    return (jcfg, jparams, port_llama.tiny(num_experts=num_experts), tokens,
            np.roll(tokens, -1, axis=-1))


@pytest.mark.parametrize("chunks", [4, 8])
@pytest.mark.parametrize("num_experts", [0, 4], ids=["dense", "moe"])
def test_vocab_chunks_loss_and_grads_match_jax(num_experts, chunks):
    jcfg, jparams, cfg, tokens, targets = _llama_case(num_experts)
    with pallas_config.force("interpret"):
        ref_loss, ref_grads = jax.value_and_grad(jax_llama.loss_fn)(
            jparams, (jnp.asarray(tokens), jnp.asarray(targets)), jcfg,
            tp_axis=None, cp_axis=None, ep_axis=None, remat=False,
            vocab_chunks=chunks)
    params = _port_params(jparams)
    batch = _port_batch(tokens, targets)
    loss, grads = _grads(lambda t: port_llama.loss_fn(
        t, batch, cfg, remat=False, vocab_chunks=chunks), params)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _assert_tree_close(_tree.unflatten(_tree.paths(params), grads),
                       ref_grads, GRAD_ATOL, GRAD_RTOL, "grad")
    # and the streamed loss equals the full-logits one
    full, _ = _grads(lambda t: port_llama.loss_fn(t, batch, cfg,
                                                  remat=False), params)
    np.testing.assert_allclose(float(loss), float(full), rtol=1e-6)


def _family_case(name: str):
    """(loss_of(params, remat), params) of a tiny model, fp32."""
    gen = torch.Generator().manual_seed(0)
    if name in ("llama", "llama_moe"):
        cfg = port_llama.tiny(num_experts=4 if name == "llama_moe" else 0)
        params = port_llama.init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
        batch = (tokens, torch.roll(tokens, -1, dims=-1))
        return (lambda p, remat: port_llama.loss_fn(p, batch, cfg,
                                                    remat=remat), params)
    model = {"gpt2": gpt2, "bert": bert}[name]
    cfg = model.tiny()
    params = model.init_params(gen, cfg, device="cpu")
    tokens = torch.randint(4, cfg.vocab_size, (2, 24), generator=gen)
    if name == "gpt2":
        batch = (tokens, torch.roll(tokens, -1, dims=-1))
        return (lambda p, remat: gpt2.loss_fn(p, batch, cfg, remat=remat),
                params)
    pad = torch.arange(24)[None, :] >= torch.tensor([24, 17])[:, None]
    batch = (tokens, tokens, (~pad).float())
    return (lambda p, remat: bert.loss_fn(p, batch, cfg, pad_mask=pad,
                                          remat=remat), params)


FAMILIES = ["llama", "llama_moe", "gpt2", "bert"]


@pytest.mark.parametrize("family", FAMILIES)
def test_dots_equals_no_remat(family):
    loss_of, params = _family_case(family)
    loss0, g0 = _grads(lambda p: loss_of(p, False), params)
    loss1, g1 = _grads(lambda p: loss_of(p, "dots"), params)
    assert float(loss0) == float(loss1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, atol=REMAT_ATOL, rtol=REMAT_RTOL)


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls while it is active."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_mm(loss_of, params, remat) -> int:
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(live, remat)
    with _CountMM() as count:
        torch.autograd.grad(loss, _tree.leaves(live))
    return count.mm


@pytest.mark.parametrize("family", FAMILIES)
def test_dots_recomputes_no_saved_product(family):
    """The backward under "dots" runs exactly the products of the
    backward with no recompute: no layer's mm runs again. Full recompute
    runs them again (more mm calls)."""
    loss_of, params = _family_case(family)
    plain = _backward_mm(loss_of, params, False)
    dots = _backward_mm(loss_of, params, "dots")
    full = _backward_mm(loss_of, params, True)
    assert plain > 0
    assert dots == plain
    assert full > plain


def test_remat_refuses_unknown_policies():
    loss_of, params = _family_case("llama")
    with pytest.raises(ValueError, match="dots"):
        loss_of(params, "offload")
