"""Parity of the port's GPT-2 training slice (apex_tpu_torch.models.gpt2
loss_fn / train_step with fused_adam) with the JAX package on tiny(),
fp32, from the same numpy params and batch.

The JAX side runs its Pallas kernels (LayerNorm forward and backward,
the causal fused softmax) in interpret mode; the port takes the kernels'
plain versions on the CPU. Both compute in fp32 and sum in different
orders: the loss agrees to LOSS_RTOL = 1e-5 and every gradient leaf to
GRAD_ATOL/GRAD_RTOL = 1e-4. After 3 Adam steps each param leaf's
displacement agrees to STEP_RTOL in relative L2, as in
test_torch_training.py (Adam moves an element whose gradient is
rounding noise by up to lr on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt2 as jax_gpt2
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch.models import gpt2 as port_gpt2
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.transformer.functional import fused_softmax as port_sm

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
STEP_RTOL = 1e-3
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    """tiny() params with every leaf moved off its init (biases 0, norm
    weights 1) by seeded noise, so the bias and affine paths are
    exercised; and the JAX references, computed once."""
    jcfg = jax_gpt2.tiny()
    params = jax.tree_util.tree_map(
        np.asarray, jax_gpt2.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    refs = {}
    with pallas_config.force("interpret"):
        for chunks in (8, None):
            refs[chunks] = jax.value_and_grad(jax_gpt2.loss_fn)(
                jparams, jbatch, jcfg, tp_axis=None, remat=False,
                vocab_chunks=chunks)
    return jcfg, params, tokens, targets, refs


def _batch(tokens, targets):
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


def test_params_from_numpy_keeps_layout(model):
    jcfg, params, *_ = model
    got = port_gpt2.params_from_numpy(params, device="cpu")
    assert got["layers"]["wqkv"].shape == (2, 64, 3, 64)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    init = port_gpt2.init_params(torch.Generator().manual_seed(0),
                                 port_gpt2.tiny(), device="cpu")
    assert _tree.paths(init) == _tree.paths(got)
    assert all(a.shape == b.shape for a, b in zip(_tree.leaves(init),
                                                  _tree.leaves(got)))


@pytest.mark.parametrize("remat,vocab_chunks", [(False, 8), (True, 8),
                                                (True, None)])
def test_loss_and_grads_match_jax(model, remat, vocab_chunks):
    """loss_fn and every grad leaf against jax.value_and_grad(loss_fn)
    with tp unbound; remat recomputes each layer in the backward and must
    change nothing."""
    jcfg, params, tokens, targets, refs = model
    ref_loss, ref_grads = refs[vocab_chunks]
    live = _tree.map_leaves(lambda p: p.requires_grad_(),
                            port_gpt2.params_from_numpy(params, device="cpu"))
    before = (port_ln.ln_launches, port_sm.causal_launches)
    loss = port_gpt2.loss_fn(live, _batch(tokens, targets), port_gpt2.tiny(),
                             remat=remat, vocab_chunks=vocab_chunks)
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    assert (port_ln.ln_launches, port_sm.causal_launches) == before
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    _assert_tree_close(_tree.unflatten(_tree.paths(live), list(grads)),
                       ref_grads, GRAD_ATOL, GRAD_RTOL, "grad")


def test_forward_logits_match_jax(model):
    jcfg, params, tokens, _, _ = model
    with pallas_config.force("interpret"):
        ref = jax_gpt2.forward(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(tokens), jcfg, tp_axis=None,
                               remat=False)
    got = port_gpt2.forward(port_gpt2.params_from_numpy(params, device="cpu"),
                            torch.from_numpy(tokens).long(), port_gpt2.tiny(),
                            remat=False)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_three_train_steps_match_jax_step(model):
    """3 train_steps with fused_adam (tree mode, as bench.py's GPT-2 step)
    against value_and_grad -> fused_adam.update -> tree_map(add), with
    vocab_chunks=8 and remat on: losses, and each param leaf's
    displacement."""
    jcfg, params, tokens, targets, _ = model
    jtx = jax_fused_adam(lr=LR)

    @jax.jit
    def jstep(p, opt_state, batch):
        loss, grads = jax.value_and_grad(jax_gpt2.loss_fn)(
            p, batch, jcfg, tp_axis=None, vocab_chunks=8)
        updates, opt_state = jtx.update(grads, opt_state, p)
        return jax.tree_util.tree_map(jnp.add, p, updates), opt_state, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    p = port_gpt2.params_from_numpy(params, device="cpu")
    start = port_gpt2.params_from_numpy(params, device="cpu")
    tx = fused_adam(lr=LR)
    state = tx.init(p)
    losses = []
    with pallas_config.force("interpret"):
        jstate = jtx.init(jp)
        for _ in range(3):
            jp, jstate, jloss = jstep(jp, jstate, jbatch)
            p, state, loss = port_gpt2.train_step(
                p, state, _batch(tokens, targets), port_gpt2.tiny(), tx,
                remat=True, vocab_chunks=8)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL)
            losses.append(float(loss))
    assert losses[-1] < losses[0]
    for path, ref in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got, p0 = p, start
        for key in path:
            got, p0 = got[key.key], p0[key.key]
        ref = torch.from_numpy(np.array(ref))
        if path[-1].key == "bqkv":
            # the key bias adds q.bk to every score of a row, which the
            # softmax cancels: its gradient is 0 up to rounding, and Adam
            # moves each element of it by up to lr on either side, so
            # only the query and value biases are compared
            got, p0, ref = (t[:, (0, 2)] for t in (got, p0, ref))
        moved = got - p0
        err = torch.linalg.vector_norm(moved - (ref - p0))
        assert err <= STEP_RTOL * torch.linalg.vector_norm(moved), (
            jax.tree_util.keystr(path), float(err))
