"""Parity of the port's BERT training slice (apex_tpu_torch.models.bert
loss_fn / train_step with fused_lamb) with the JAX package on tiny(),
fp32, with a padding mask, token types and a loss mask, from the same
numpy params and batch.

The JAX side runs its Pallas kernels (LayerNorm forward and backward,
the padding-masked fused softmax) in interpret mode; the port takes the
kernels' plain versions on the CPU. Both compute in fp32 and sum in
different orders: the loss agrees to LOSS_RTOL = 1e-5 and every
gradient leaf to GRAD_ATOL/GRAD_RTOL = 1e-4. After 3 LAMB steps each
param leaf's displacement agrees to STEP_RTOL in relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import bert as jax_bert
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import _tree
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.optimizers import fused_lamb
from apex_tpu_torch.transformer.functional import fused_softmax as port_sm

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
STEP_RTOL = 1e-3
LR = 1e-2
B, S = 2, 24


@pytest.fixture(scope="module")
def model():
    """tiny() params moved off their init by seeded noise (plus an HF-style
    ``mlm_decoder_bias``), a batch whose second row is padded after 17
    tokens, and the JAX references, computed once."""
    jcfg = jax_bert.tiny()
    params = jax.tree_util.tree_map(
        np.asarray, jax_bert.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params)
    params["mlm_decoder_bias"] = (
        0.1 * rng.standard_normal(jcfg.vocab_size)).astype(np.float32)
    targets = rng.integers(4, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    pad = np.zeros((B, S), bool)
    pad[1, 17:] = True
    masked = (rng.random((B, S)) < 0.3) & ~pad
    tokens = np.where(masked, 3, np.where(pad, 0, targets)).astype(np.int32)
    type_ids = (np.arange(S)[None, :] >= 12).astype(np.int32).repeat(B, 0)
    data = dict(tokens=tokens, targets=targets,
                loss_mask=masked.astype(np.float32), pad=pad,
                type_ids=type_ids)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    refs = {}
    with pallas_config.force("interpret"):
        for chunks in (8, None):
            refs[chunks] = jax.value_and_grad(jax_bert.loss_fn)(
                jparams, _jbatch(data), jcfg, type_ids=jnp.asarray(type_ids),
                pad_mask=jnp.asarray(pad), tp_axis=None, remat=False,
                vocab_chunks=chunks)
    return jcfg, params, data, refs


def _jbatch(d):
    return (jnp.asarray(d["tokens"]), jnp.asarray(d["targets"]),
            jnp.asarray(d["loss_mask"]))


def _batch(d):
    return (torch.from_numpy(d["tokens"]).long(),
            torch.from_numpy(d["targets"]).long(),
            torch.from_numpy(d["loss_mask"]))


def _kw(d):
    return dict(type_ids=torch.from_numpy(d["type_ids"]).long(),
                pad_mask=torch.from_numpy(d["pad"]))


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
    _, params, _, _ = model
    got = port_bert.params_from_numpy(params, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    init = port_bert.init_params(torch.Generator().manual_seed(0),
                                 port_bert.tiny(), device="cpu")
    assert sorted(_tree.paths(init) + [("mlm_decoder_bias",)]) == \
        _tree.paths(got)


@pytest.mark.parametrize("remat,vocab_chunks", [(False, 8), (True, 8),
                                                (True, None)])
def test_loss_and_grads_match_jax(model, remat, vocab_chunks):
    """loss_fn and every grad leaf (the decoder bias's too) against
    jax.value_and_grad(loss_fn) with a pad_mask, type_ids and a loss
    mask."""
    _, params, data, refs = model
    ref_loss, ref_grads = refs[vocab_chunks]
    live = _tree.map_leaves(lambda p: p.requires_grad_(),
                            port_bert.params_from_numpy(params, device="cpu"))
    before = (port_ln.ln_launches, port_sm.masked_launches)
    loss = port_bert.loss_fn(live, _batch(data), port_bert.tiny(),
                             remat=remat, vocab_chunks=vocab_chunks,
                             **_kw(data))
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    assert (port_ln.ln_launches, port_sm.masked_launches) == before
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    _assert_tree_close(_tree.unflatten(_tree.paths(live), list(grads)),
                       ref_grads, GRAD_ATOL, GRAD_RTOL, "grad")


def test_forward_without_padding_matches_jax(model):
    """No pad_mask and no type_ids: the masked softmax is the plain one
    and every token takes type 0."""
    jcfg, params, data, _ = model
    with pallas_config.force("interpret"):
        ref = jax_bert.forward(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(data["tokens"]), jcfg,
                               tp_axis=None, remat=False)
    got = port_bert.forward(port_bert.params_from_numpy(params, device="cpu"),
                            torch.from_numpy(data["tokens"]).long(),
                            port_bert.tiny(), remat=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_three_train_steps_match_jax_step(model):
    """3 train_steps with fused_lamb (as bench.py's BERT step) against
    value_and_grad -> fused_lamb.update -> tree_map(add), with remat on
    and the padding mask: losses, and each param leaf's displacement."""
    jcfg, params, data, _ = model
    jtx = jax_fused_lamb(lr=LR)

    @jax.jit
    def jstep(p, opt_state, batch):
        loss, grads = jax.value_and_grad(jax_bert.loss_fn)(
            p, batch, jcfg, type_ids=jnp.asarray(data["type_ids"]),
            pad_mask=jnp.asarray(data["pad"]), tp_axis=None)
        updates, opt_state = jtx.update(grads, opt_state, p)
        return jax.tree_util.tree_map(jnp.add, p, updates), opt_state, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    p = port_bert.params_from_numpy(params, device="cpu")
    start = port_bert.params_from_numpy(params, device="cpu")
    tx = fused_lamb(lr=LR)
    state = tx.init(p)
    losses = []
    with pallas_config.force("interpret"):
        jstate = jtx.init(jp)
        for _ in range(3):
            jp, jstate, jloss = jstep(jp, jstate, _jbatch(data))
            p, state, loss = port_bert.train_step(
                p, state, _batch(data), port_bert.tiny(), tx, remat=True,
                **_kw(data))
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
            # the key bias's gradient is 0 up to rounding (the softmax
            # cancels q.bk), which the optimizer turns into steps of
            # either sign: compare the query and value biases only
            got, p0, ref = (t[:, (0, 2)] for t in (got, p0, ref))
        moved = got - p0
        err = torch.linalg.vector_norm(moved - (ref - p0))
        assert err <= STEP_RTOL * torch.linalg.vector_norm(moved), (
            jax.tree_util.keystr(path), float(err))
