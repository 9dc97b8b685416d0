"""Parity of the port's fused Adam (apex_tpu_torch.optimizers) with the
JAX package's: flat mode through the Pallas kernel (_adam_kernel) in
interpret mode, tree mode through _math.adam_step, over 3 steps.

Params and per-step grads come from numpy with a fixed seed; the tree
holds fp32 and bf16 params, so flat mode packs one slab of each. The
update is fp32 elementwise math in the same order on both sides, with
the bias corrections and the learning rate rounded to fp32 as the Pallas
launcher rounds them. XLA may contract a * b + c into one FMA where the
port rounds the product first, so fp32 results agree to a few ulps of
the operands (RTOL, and ATOL where m = b1*m + (1-b1)*g cancels); bf16
params within one bf16 ulp. On the CPU the port takes
_adam_flat_plain; the CUDA kernel is held against it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flat as jax_flat
from apex_tpu.ops import pallas_config
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch.models.llama import params_from_numpy
from apex_tpu_torch.ops import flat as port_flat
from apex_tpu_torch.ops import fused_adam_kernel as port_kernel
from apex_tpu_torch.optimizers import fused_adam, opt_state_from_numpy

RTOL, ATOL = 4e-6, 2e-7
STEPS = 3


def _make_tree(seed):
    """A nested dict whose keys are out of order at every level."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"w2": arr(3, 5), "b": {"z": arr(7), "a": arr(2, 2, 3)},
            "a_bf16": arr(11), "scale": arr()}


def _to_jax(tree):
    return {k: (_to_jax(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k.endswith("bf16")
                            else jnp.float32))
            for k, v in tree.items()}


def _to_port(tree):
    """The same tree as torch tensors on the CPU, keeping each dict's own
    (unsorted) key order, so the port's leaf order is put to the test."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_port(v)
        else:
            t = torch.from_numpy(np.array(v))
            out[k] = t.to(torch.bfloat16) if k.endswith("bf16") else t
    return out


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_tree_close(port_tree, jax_tree, what):
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    for path, ref in flat_j:
        node = port_tree
        for key in path:
            node = node[key.key]
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        got = node.float().numpy()
        name = f"{what}{jax.tree_util.keystr(path)}"
        if node.dtype == torch.bfloat16:
            assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), name
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def _run_both(flat, **kw):
    params0 = _make_tree(0)
    grads = [_make_tree(1 + i) for i in range(STEPS)]
    jtx = jax_fused_adam(lr=1e-2, flat=flat,
                                    use_kernel=True if flat else None, **kw)
    jparams = _to_jax(params0)
    jstate = jtx.init(jparams)
    with pallas_config.force("interpret"):
        for g in grads:
            jg = jax.tree_util.tree_map(
                lambda a, p: jnp.asarray(a, p.dtype), _to_jax(g), jparams)
            upd, jstate = jtx.update(jg, jstate, jparams)
            jparams = jax.tree_util.tree_map(jnp.add, jparams, upd)

    tx = fused_adam(lr=1e-2, flat=flat, **kw)
    params = _to_port(params0)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(_to_port(g), state, params)
        for p, u in zip(_tree.leaves(params), _tree.leaves(upd)):
            p.add_(u)
    return (params, state), (jparams, jstate)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("flat", [True, False])
def test_three_steps_match_jax(flat, adam_w_mode, weight_decay,
                               bias_correction):
    """Params, count, mu and nu after 3 steps: flat against the Pallas
    kernel (interpret), tree against the JAX tree path."""
    (params, state), (jparams, jstate) = _run_both(
        flat, adam_w_mode=adam_w_mode, weight_decay=weight_decay,
        bias_correction=bias_correction)
    _assert_tree_close(params, jparams, "params")
    assert int(state.count) == int(jstate.count) == STEPS
    assert state.count.dtype == torch.int32
    if flat:
        assert sorted(state.mu) == sorted(jstate.mu) == [
            "bfloat16", "float32"]
        for k in jstate.mu:
            for got, ref in ((state.mu[k], jstate.mu[k]),
                             (state.nu[k], jstate.nu[k])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=RTOL, atol=ATOL)
    else:
        for got, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            _assert_tree_close(got, ref, "state")


def test_plain_kernel_matches_pallas_kernel_in_one_call():
    """adam_flat's plain version against adam_flat_pallas(interpret) on
    the same slabs, with m and v updated in place."""
    from apex_tpu.ops import fused_adam_kernel as jax_kernel

    rng = np.random.default_rng(4)
    n = 1000
    g, p = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = 0.1 * rng.standard_normal(n).astype(np.float32)
    v = np.abs(0.1 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              adam_w_mode=True, bias_correction=True)
    ref = jax_kernel.adam_flat_pallas(
        jnp.asarray(g), jnp.asarray(p, jnp.bfloat16), jnp.asarray(m),
        jnp.asarray(v), jnp.float32(3e-4), jnp.float32(5.0), interpret=True,
        **kw)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    delta, m2, v2 = port_kernel.adam_flat(
        torch.from_numpy(g), torch.from_numpy(p).to(torch.bfloat16), tm, tv,
        3e-4, 5, **kw)
    assert m2 is tm and v2 is tv and delta.dtype == torch.bfloat16
    d_ref = np.asarray(ref[0].astype(jnp.float32))
    assert np.all(np.abs(delta.float().numpy() - d_ref) <= _bf16_ulp(d_ref))
    np.testing.assert_allclose(tm.numpy(), np.asarray(ref[1]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref[2]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("flat", [True, False])
def test_opt_state_from_numpy_round_trips(flat):
    """A JAX FusedAdamState (after one step, in either mode) converts to
    the port's bit for bit, and one more step from it matches JAX's."""
    jtx = jax_fused_adam(lr=1e-2, flat=flat,
                                    use_kernel=True if flat else None)
    jparams = _to_jax(_make_tree(0))
    jg = [jax.tree_util.tree_map(lambda a, p: jnp.asarray(a, p.dtype),
                                 _to_jax(_make_tree(s)), jparams)
          for s in (1, 2)]
    with pallas_config.force("interpret"):
        jstate = jtx.init(jparams)
        upd, jstate = jtx.update(jg[0], jstate, jparams)
        jparams = jax.tree_util.tree_map(jnp.add, jparams, upd)
        state = opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
        assert int(state.count) == 1
        for got, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
                np.testing.assert_array_equal(
                    _at(got, [k.key for k in path]).numpy(), np.asarray(r))
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        upd2, jstate2 = jtx.update(jg[1], jstate, jparams)
    tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, jg[1]),
                           device="cpu")
    tx = fused_adam(lr=1e-2, flat=flat)
    upd_port, state2 = tx.update(tg, state, params)
    _assert_tree_close(upd_port, upd2, "updates")
    assert int(state2.count) == int(jstate2.count) == 2


def test_flat_leaf_order_equals_jax_flatten_tree():
    """flatten_tree packs leaves in jax.tree_util's order (dict keys
    sorted at every level), one buffer per JAX dtype name."""
    jtree = _to_jax(_make_tree(3))
    jbufs, (_, n_leaves, jspecs) = jax_flat.flatten_tree(jtree)
    ptree = _to_port(_make_tree(3))
    assert list(ptree) != sorted(ptree)
    bufs, meta = port_flat.flatten_tree(ptree)
    assert sorted(bufs) == sorted(jbufs)
    assert meta[1] == n_leaves
    for k, buf in bufs.items():
        assert meta[2][k][0] == jspecs[k][0]
        assert meta[2][k][1].offsets == jspecs[k][1].offsets
        np.testing.assert_array_equal(
            buf.float().numpy(),
            np.asarray(jnp.asarray(jbufs[k], jnp.float32)))
    back = port_flat.unflatten_tree(bufs, meta)
    for path, leaf in zip(_tree.paths(ptree), _tree.leaves(ptree)):
        assert torch.equal(_at(back, path), leaf)


def test_flat_update_on_cpu_never_counts_a_launch():
    before = port_kernel.launches
    params = _to_port(_make_tree(0))
    tx = fused_adam(flat=True)
    tx.update(params, tx.init(params), params)
    assert port_kernel.launches == before
