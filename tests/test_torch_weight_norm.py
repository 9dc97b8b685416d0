"""Parity of the port's weight norm (apex_tpu_torch.reparameterization)
with the JAX package's on the same numpy trees: apply (every eligible
leaf, or one named), compute and remove, at dim 0, 1 and over the whole
weight, within 1e-5; the gradients to g and v through the forward's
``compute_weights`` against ``jax.grad`` within 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import reparameterization as jrp
from apex_tpu_torch import _tree
from apex_tpu_torch import reparameterization as prp

ATOL = 1e-5
GRAD_REL = 1e-4


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _wn_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w_ih": rng.standard_normal((8, 4)).astype(np.float32),
            "b_ih": rng.standard_normal(8).astype(np.float32),
            "sub": {"w_hh": rng.standard_normal((8, 2)).astype(np.float32),
                    "k": rng.standard_normal((3, 2, 2)).astype(np.float32)}}


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pt(tree):
    return _tree.map_leaves(lambda a: torch.from_numpy(np.array(a)), tree)


def _tree_close(port, ref, atol=ATOL):
    got, _ = _tree.flatten_with_path(port)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("dim", [0, 1, None], ids=["dim0", "dim1", "all"])
@pytest.mark.parametrize("name", ["", "w_hh"], ids=["every", "named"])
def test_weight_norm_apply_compute_remove_match_jax(dim, name):
    tree = _wn_tree(0)
    japplied = jrp.apply_weight_norm(_jt(tree), name=name, dim=dim)
    applied = prp.apply_weight_norm(_pt(tree), name=name, dim=dim)
    _tree_close(applied, japplied)
    _tree_close(prp.compute_weights(applied, dim=dim),
                jrp.compute_weights(japplied, dim=dim))
    _tree_close(prp.remove_weight_norm(applied, dim=dim),
                jrp.remove_weight_norm(japplied, dim=dim))
    _tree_close(prp.remove_weight_norm(applied, dim=dim), _jt(tree))
    assert "b_ih" in applied  # 1-dim leaves stay
    _tree_close(prp.apply_reparameterization(_pt(tree), name=name, dim=dim),
                jrp.apply_reparameterization(_jt(tree), name=name, dim=dim))
    _tree_close(prp.remove_reparameterization(applied),
                jrp.remove_reparameterization(japplied))


def test_weight_norm_gradients_match_jax():
    tree = _wn_tree(1)
    x = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)

    def jloss(p):
        w = jrp.compute_weights(p)
        return jnp.sum(jnp.tanh(x @ w["w_ih"].T) ** 2) + jnp.sum(
            w["sub"]["w_hh"] ** 3)

    japplied = jrp.apply_weight_norm(_jt(tree))
    jg = jax.grad(jloss)(japplied)
    applied = _tree.map_leaves(lambda t: t.requires_grad_(True),
                               prp.apply_weight_norm(_pt(tree)))
    w = prp.compute_weights(applied)
    loss = torch.sum(torch.tanh(torch.from_numpy(x) @ w["w_ih"].T) ** 2) \
        + torch.sum(w["sub"]["w_hh"] ** 3)
    loss.backward()
    got, _ = _tree.flatten_with_path(applied)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, g), (_, ref) in zip(got, want):
        if g.grad is None:  # k (3-D) is not in the loss
            assert float(np.abs(np.asarray(ref)).max()) == 0.0, path
            continue
        assert _rel_l2(g.grad.numpy(), np.asarray(ref)) <= GRAD_REL, path


def test_weight_norm_keeps_the_dtype_and_the_epsilon():
    v = torch.zeros(3, 4, dtype=torch.bfloat16)
    g = torch.ones(3, 1, dtype=torch.bfloat16)
    w = prp.WeightNorm.compute_weight(g, v)
    assert w.dtype == torch.bfloat16 and torch.isfinite(w.float()).all()
    g2, v2 = prp.WeightNorm.reparameterize(torch.ones(3, 4))
    assert g2.shape == (3, 1) and float(g2[0, 0]) == 2.0 and v2.shape == (3, 4)
    assert prp.Reparameterization is prp.WeightNorm
    with pytest.raises(ValueError, match="WeightNorm"):
        prp.apply_reparameterization({}, reparameterization=object())
    # a list is not walked, as in the reference
    rnn_params = [{"w_ih": torch.ones(4, 2)}]
    assert prp.apply_weight_norm(rnn_params) is rnn_params
