"""The port's ASP (``apex_tpu_torch.contrib.sparsity``) against the JAX
package's, after ``tests/contrib/test_contrib.py`` ``TestSparsity``: the
masks equal the reference's exactly (ties included: the reference's
double argsort keeps the earlier of two equal magnitudes, the port's
stable sort too), the copied permutation search returns the reference's
permutation for the same weights and seed, and 3 masked ``fused_adam``
steps give the reference's params (RTOL/ATOL of the fp32 Adam
arithmetic, 1e-5 / 1e-6) with every pruned weight exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.contrib import sparsity as jsp
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch.contrib import sparsity as sp
from apex_tpu_torch.optimizers import fused_adam

RTOL, ATOL = 1e-5, 1e-6


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(16, 32), (3, 4, 8)])
def test_mn_1d_mask_matches_reference(shape):
    w = _w(0, shape)
    got = sp.mn_1d_mask(torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsp.mn_1d_mask(
        jnp.asarray(w))))
    assert got.mean() == 0.5


def test_mn_1d_mask_ties_follow_the_reference():
    """Groups with equal magnitudes (and signs mixed): the reference's
    rank order keeps the first two of the tied ones."""
    w = np.array([[1.0, 1.0, 1.0, 1.0, -2.0, 2.0, 2.0, 0.5,
                   0.0, 0.0, 0.0, 0.0, 3.0, -1.0, 1.0, -1.0]], np.float32)
    got = sp.mn_1d_mask(torch.tensor(w)).numpy()
    want = np.asarray(jsp.mn_1d_mask(jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :4], [True, True, False, False])
    with pytest.raises(ValueError, match="not divisible"):
        sp.mn_1d_mask(torch.zeros(2, 6))


def test_create_mask_2d_matches_reference():
    w = _w(1, (16, 16))
    got = sp.create_mask(torch.tensor(w), "m4n2_2d_best").numpy()
    np.testing.assert_array_equal(got, np.asarray(jsp.create_mask(
        jnp.asarray(w), "m4n2_2d_best")))
    assert got.mean() <= 0.5
    with pytest.raises(ValueError, match="unknown pattern"):
        sp.create_mask(torch.tensor(w), "m8n1")


def test_permutation_search_is_the_reference():
    """The adversarial layout of ``test_permutation_search_beats_naive``:
    big channels packed into the first groups."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=(8, 8)) * 10.0,
                        rng.normal(size=(8, 24)) * 0.1], axis=1).astype(
        np.float32)
    perm = sp.find_channel_permutation(torch.tensor(w))
    np.testing.assert_array_equal(
        perm, jsp.find_channel_permutation(jnp.asarray(w)))
    mask, perm2 = sp.permuted_mn_mask(torch.tensor(w))
    jmask, jperm = jsp.permuted_mn_mask(jnp.asarray(w))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(perm2, jperm)
    naive = sp.mn_1d_mask(torch.tensor(w))
    assert (sp.retained_magnitude(torch.tensor(w), mask)
            > sp.retained_magnitude(torch.tensor(w), naive))
    assert (mask.numpy()[:, perm2].reshape(8, 8, 4).sum(-1) == 2).all()


def test_permuted_mask_never_loses_to_naive():
    w = torch.tensor(_w(3, (16, 32)))
    mask, _ = sp.permuted_mn_mask(w)
    assert (sp.retained_magnitude(w, mask)
            >= sp.retained_magnitude(w, sp.mn_1d_mask(w)) - 1e-6)


def _params():
    return {"dense": {"w": _w(4, (8, 16)), "b": _w(5, (16,))},
            "proj": {"kernel": _w(6, (16, 12))}}


def test_asp_masks_match_reference():
    params = _params()
    masks = sp.ASP.compute_sparse_masks(
        _tree.map_leaves(torch.tensor, params))
    jmasks = jsp.ASP.compute_sparse_masks(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert masks["dense"]["b"] is None and jmasks["dense"]["b"] is None
    for path in (("dense", "w"), ("proj", "kernel")):
        np.testing.assert_array_equal(
            masks[path[0]][path[1]].numpy(),
            np.asarray(jmasks[path[0]][path[1]]))
    perm_masks = sp.ASP.compute_sparse_masks(
        _tree.map_leaves(torch.tensor, params), allow_permutation=True)
    assert float(perm_masks["dense"]["w"].float().mean()) == 0.5
    with pytest.raises(ValueError, match="allow_permutation"):
        sp.ASP.compute_sparse_masks(_tree.map_leaves(torch.tensor, params),
                                    "m4n2_2d_best", allow_permutation=True)


@pytest.mark.parametrize("flat", [False, True])
def test_asp_masked_training_matches_reference(flat):
    """``test_asp_masked_training_preserves_sparsity``: 3 masked steps of
    ``fused_adam(lr=0.1)`` (the port's also with ``flat=True``, the flat
    Adam kernel's path) against the reference's optax steps."""
    params = _params()
    x = _w(7, (4, 8))

    def jloss(p):
        h = jnp.asarray(x) @ p["dense"]["w"] + p["dense"]["b"]
        return jnp.mean((h @ p["proj"]["kernel"] - 1.0) ** 2)

    jp, jmasks = jsp.ASP.init_model_for_pruning(
        jax.tree_util.tree_map(jnp.asarray, params))
    jtx = jsp.ASP.init_optimizer_for_pruning(j_fused_adam(lr=0.1), jmasks)
    jstate = jtx.init(jp)
    for _ in range(3):
        u, jstate = jtx.update(jax.grad(jloss)(jp), jstate, jp)
        jp = optax.apply_updates(jp, u)

    p, masks = sp.ASP.init_model_for_pruning(
        _tree.map_leaves(torch.tensor, params))
    tx = sp.ASP.init_optimizer_for_pruning(fused_adam(lr=0.1, flat=flat),
                                           masks)
    state = tx.init(p)
    xs = torch.tensor(x)
    for _ in range(3):
        live = _tree.map_leaves(lambda t: t.detach().requires_grad_(), p)
        h = xs @ live["dense"]["w"] + live["dense"]["b"]
        loss = torch.mean((h @ live["proj"]["kernel"] - 1.0) ** 2)
        g = torch.autograd.grad(loss, _tree.leaves(live))
        u, state = tx.update(_tree.unflatten(_tree.paths(p), list(g)),
                             state, p)
        p = _tree.unflatten(_tree.paths(p), [
            a + b for a, b in zip(_tree.leaves(p), _tree.leaves(u))])
    for path, got in zip(_tree.paths(p), _tree.leaves(p)):
        want = np.asarray(jp[path[0]][path[1]])
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    for name, key in (("dense", "w"), ("proj", "kernel")):
        pruned = ~masks[name][key]
        assert (p[name][key][pruned] == 0).all()
        assert float((p[name][key] != 0).float().mean()) <= 0.5
