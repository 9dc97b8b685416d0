"""Parity of the port's training slice (apex_tpu_torch.models.llama
loss_fn / train_step with fused_adam) with the JAX package on tiny(),
fp32, from the same numpy params and batch.

The JAX side runs its Pallas kernels (flash forward and backward,
RMSNorm forward and backward, flat Adam) in interpret mode; the port
takes the kernels' plain versions on the CPU. Both compute in fp32 and
sum in different orders, so the loss and every gradient leaf agree to
GRAD_ATOL/GRAD_RTOL. After 3 Adam steps the optimizer state agrees to
the same tolerance, and each param leaf's displacement from its start
to STEP_RTOL in relative L2: Adam divides every gradient element by its
own running RMS, so an element whose gradient is rounding noise (a
relative error near 1) still moves by up to lr a step, on either side,
and an elementwise bound would have to be lr itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import llama as jax_llama
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.transformer.tensor_parallel import cross_entropy as jax_ce
from apex_tpu_torch import _tree
from apex_tpu_torch.models import llama as port_llama
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
STEP_RTOL = 1e-3
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.tiny()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    return jcfg, jparams, port_llama.tiny(), tokens, targets


def _port_params(jparams):
    return port_llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port_batch(tokens, targets):
    return (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())


def _assert_tree_close(port_tree, jax_tree, atol, rtol, what):
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat_j) == len(_tree.leaves(port_tree))
    for path, ref in flat_j:
        node = port_tree
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == ref.shape
        np.testing.assert_allclose(
            node.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _port_value_and_grad(params, batch, cfg, remat):
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = port_llama.loss_fn(live, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    return loss, _tree.unflatten(_tree.paths(params), list(grads))


def test_loss_and_grads_match_jax(model):
    """loss_fn and every grad leaf against jax.value_and_grad(loss_fn)
    with tp/cp unbound, remat off, Pallas kernels in interpret mode."""
    jcfg, jparams, cfg, tokens, targets = model
    with pallas_config.force("interpret"):
        ref_loss, ref_grads = jax.value_and_grad(jax_llama.loss_fn)(
            jparams, (jnp.asarray(tokens), jnp.asarray(targets)), jcfg,
            tp_axis=None, cp_axis=None, remat=False)
    loss, grads = _port_value_and_grad(_port_params(jparams),
                                       _port_batch(tokens, targets), cfg,
                                       remat=False)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _assert_tree_close(grads, ref_grads, GRAD_ATOL, GRAD_RTOL, "grad")


def test_remat_equals_no_remat(model):
    """Per-layer recompute (torch.utils.checkpoint) gives the same loss
    and grads as keeping the activations."""
    jcfg, jparams, cfg, tokens, targets = model
    params = _port_params(jparams)
    batch = _port_batch(tokens, targets)
    loss0, g0 = _port_value_and_grad(params, batch, cfg, remat=False)
    loss1, g1 = _port_value_and_grad(params, batch, cfg, remat=True)
    assert float(loss0) == float(loss1)
    for a, b in zip(_tree.leaves(g0), _tree.leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="dots"):
        port_llama.loss_fn(params, batch, cfg, remat="dots")


def test_three_train_steps_match_jax_step(model):
    """3 train_steps with fused_adam(flat=True) against a bench.py-style
    JAX step (value_and_grad -> fused_adam(flat=True, use_kernel=True)
    -> tree_map(add)): losses, params and the flat m/v slabs."""
    jcfg, jparams, cfg, tokens, targets = model
    jtx = jax_fused_adam(lr=LR, flat=True, use_kernel=True)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jax_llama.loss_fn)(
            params, batch, jcfg, tp_axis=None, cp_axis=None, remat=False)
        updates, opt_state = jtx.update(grads, opt_state, params)
        return (jax.tree_util.tree_map(jnp.add, params, updates),
                opt_state, loss)

    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    params = _port_params(jparams)
    start = _port_params(jparams)
    tx = fused_adam(lr=LR, flat=True)
    state = tx.init(params)
    batch = _port_batch(tokens, targets)
    with pallas_config.force("interpret"):
        jstate = jtx.init(jparams)
        jp = jparams
        for _ in range(3):
            jp, jstate, jloss = jstep(jp, jstate, jbatch)
            params, state, loss = port_llama.train_step(
                params, state, batch, cfg, tx)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=1e-5)
    for path, ref in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        got, p0 = params, start
        for key in keys:
            got, p0 = got[key], p0[key]
        moved = got - p0
        ref_moved = torch.from_numpy(np.asarray(ref)) - p0
        err = torch.linalg.vector_norm(moved - ref_moved)
        assert err <= STEP_RTOL * torch.linalg.vector_norm(ref_moved), (
            keys, float(err))
    assert int(state.count) == int(jstate.count) == 3
    assert sorted(state.mu) == sorted(jstate.mu) == ["float32"]
    for got, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        np.testing.assert_allclose(got["float32"].numpy(),
                                   np.asarray(ref["float32"]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_train_step_updates_params_in_place(model):
    """The port's step writes into the caller's tensors and returns the
    same dict; the loss goes down over a few steps on one batch."""
    jcfg, jparams, cfg, tokens, targets = model
    params = _port_params(jparams)
    before = {id(t): t.clone() for t in _tree.leaves(params)}
    tx = fused_adam(lr=1e-2, flat=False)
    state = tx.init(params)
    losses = []
    for _ in range(4):
        out, state, loss = port_llama.train_step(
            params, state, _port_batch(tokens, targets), cfg, tx,
            remat=True)
        assert out is params
        losses.append(float(loss))
    assert all(not t.requires_grad for t in _tree.leaves(params))
    assert any(not torch.equal(t, before[id(t)])
               for t in _tree.leaves(params))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_value_and_grad_match_jax(label_smoothing):
    """Per-token CE and its gradient against vocab_parallel_cross_entropy
    with no tensor-parallel axis bound."""
    rng = np.random.default_rng(int(label_smoothing * 10))
    logits = (3 * rng.standard_normal((2, 5, 37))).astype(np.float32)
    target = rng.integers(0, 37, size=(2, 5))
    g = rng.standard_normal((2, 5)).astype(np.float32)

    def jloss(x):
        return jax_ce.vocab_parallel_cross_entropy(
            x, jnp.asarray(target), label_smoothing=label_smoothing,
            axis_name=None)

    ref, vjp = jax.vjp(jloss, jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    got = vocab_parallel_cross_entropy(x, torch.from_numpy(target),
                                       label_smoothing=label_smoothing)
    (grad,) = torch.autograd.grad(got, (x,), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-6, atol=1e-7)
