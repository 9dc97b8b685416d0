"""ASP, automatic 2:4 structured sparsity (port of
``apex_tpu/contrib/sparsity.py``; ref apex/contrib/sparsity/{asp.py,
sparse_masklib.py, permutation_lib.py}).

Masks are computed once (magnitude-based ``m4n2_1d``, the reference's
default, or the greedy row x column ``m4n2_2d_best``), live in a tree
like the params (``None`` where a leaf is not pruned), and are applied
functionally: :func:`apply_masks` on the params, :func:`masked_update`
around an optimizer's transform so that its updates keep the pattern.
The channel-permutation search is the JAX package's numpy search, copied
(sort-and-deal seeding, then bounded best-improvement column swaps from
``np.random.default_rng(seed)``), so the same weights give the same
permutation.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.optimizers.fused_adam import GradientTransformation

__all__ = ["ASP", "apply_masks", "create_mask", "find_channel_permutation",
           "masked_update", "mn_1d_mask", "permuted_mn_mask",
           "retained_magnitude"]


def mn_1d_mask(w: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """Keep the ``n`` largest magnitudes of every ``m`` consecutive
    weights along the last dim (ref ``:21-35``; ``sparse_masklib.py:49``
    ``m4n2_1d``): a bool mask of ``w``'s shape. Ties go to the earlier
    weight, as the reference's double argsort orders them: a stable
    descending sort."""
    if w.shape[-1] % m:
        raise ValueError(f"last dim {w.shape[-1]} not divisible by m={m}")
    mag = torch.abs(w.reshape(*w.shape[:-1], w.shape[-1] // m, m))
    order = torch.argsort(mag, dim=-1, descending=True, stable=True)
    keep = torch.zeros_like(mag, dtype=torch.bool)
    keep.scatter_(-1, order[..., :n], True)
    return keep.reshape(w.shape)


def create_mask(w: torch.Tensor, pattern: str = "m4n2_1d") -> torch.Tensor:
    """ref ``sparse_masklib.py`` ``create_mask`` (``:38-50``):
    ``m4n2_2d_best`` is the 1d pattern over the rows and over the
    columns, both kept (the greedy form of the reference's search)."""
    if pattern == "m4n2_1d":
        return mn_1d_mask(w, 4, 2)
    if pattern == "m4n2_2d_best":
        rows = mn_1d_mask(w, 4, 2)
        cols = mn_1d_mask(w.transpose(-1, -2), 4, 2).transpose(-1, -2)
        return rows & cols
    raise ValueError(f"unknown pattern {pattern}")


# --------------------------------------------------------------- permutation
# An N:M mask keeps n of m CONSECUTIVE channels, so large channels packed
# into one group lose some of their weights; permuting the input channels
# regroups them. The search below is the JAX package's numpy search
# (sparsity.py:63-151), run on the host once, before training.


def _group_retained(cols: np.ndarray, n: int) -> float:
    """Total magnitude n-of-m keeps on ``[rows, m]`` group columns."""
    s = np.sort(np.abs(cols), axis=1)[:, -n:]
    return float(s.sum())


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float64).numpy()
    return np.asarray(w, np.float64)


def find_channel_permutation(w, m: int = 4, n: int = 2, iters: int = 200,
                             pairs_per_iter: int = 2048,
                             seed: int = 0) -> np.ndarray:
    """A permutation of ``w``'s LAST dim maximising the magnitude n:m
    keeps: ``w[..., perm]`` is the permuted layout (ref ``:71-155``).

    Columns sorted by L1 norm are dealt round-robin across the groups,
    then sampled cross-group swaps improve it (best of each batch; three
    batches without a gain end it). The search objective uses at most
    4096 rows (a strided subsample); the mask is computed on all of
    them."""
    w2 = _host(w).reshape(-1, w.shape[-1])
    max_rows = 4096
    if w2.shape[0] > max_rows:
        stride = -(-w2.shape[0] // max_rows)
        w2 = w2[::stride]
    C = w2.shape[1]
    if C % m:
        raise ValueError(f"channels {C} not divisible by m={m}")
    G = C // m

    order = np.argsort(-np.abs(w2).sum(0), kind="stable")
    perm = np.empty(C, dtype=np.int64)
    for i, c in enumerate(order):
        g, slot = i % G, i // G
        perm[g * m + slot] = c

    if G < 2:
        return perm

    rng = np.random.default_rng(seed)
    cur = w2[:, perm]
    ret = np.array([_group_retained(cur[:, g * m:(g + 1) * m], n)
                    for g in range(G)])

    # candidates are scored in chunks: peak memory ~[rows, chunk, m]
    chunk = max(1, min(pairs_per_iter,
                       (8 << 20) // max(1, w2.shape[0] * m * 8)))

    def retained(cand):
        s = np.sort(np.abs(cand), axis=2)[:, :, -n:]
        return s.sum(axis=(0, 2))

    misses = 0
    for _ in range(iters):
        i = rng.integers(0, C, pairs_per_iter)
        j = rng.integers(0, C, pairs_per_iter)
        ok = (i // m) != (j // m)
        i, j = i[ok], j[ok]
        if i.size == 0:
            continue
        gi, gj = i // m, j // m
        delta = np.empty(i.size)
        for c0 in range(0, i.size, chunk):
            sl = slice(c0, min(c0 + chunk, i.size))
            idx_i = gi[sl, None] * m + np.arange(m)[None, :]
            idx_j = gj[sl, None] * m + np.arange(m)[None, :]
            cand_i = cur[:, idx_i].copy()
            cand_j = cur[:, idx_j].copy()
            p_n = idx_i.shape[0]
            cand_i[:, np.arange(p_n), i[sl] % m] = cur[:, j[sl]]
            cand_j[:, np.arange(p_n), j[sl] % m] = cur[:, i[sl]]
            delta[sl] = (retained(cand_i) + retained(cand_j)
                         - ret[gi[sl]] - ret[gj[sl]])
        best = int(np.argmax(delta))
        if delta[best] <= 1e-12:
            misses += 1
            if misses >= 3:
                break
            continue
        misses = 0
        bi, bj = int(i[best]), int(j[best])
        perm[bi], perm[bj] = perm[bj], perm[bi]
        cur[:, [bi, bj]] = cur[:, [bj, bi]]
        for g in (bi // m, bj // m):
            ret[g] = _group_retained(cur[:, g * m:(g + 1) * m], n)
    return perm


def retained_magnitude(w: torch.Tensor, mask: torch.Tensor) -> float:
    """Total ``|w|`` the mask keeps (the search's objective)."""
    return float(torch.sum(torch.abs(w) * mask.to(w.dtype)))


def permuted_mn_mask(w: torch.Tensor, m: int = 4, n: int = 2,
                     **search_kw):
    """``(mask, perm)``: a mask in ``w``'s own layout that is n:m under
    the searched permutation of its last dim (ref ``:158-180``). Never
    keeps less than the naive mask: where the naive one keeps more, it
    and the identity come back."""
    perm = find_channel_permutation(w, m, n, **search_kw)
    p = torch.as_tensor(perm, device=w.device)
    mask_p = mn_1d_mask(w[..., p], m, n)
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.numel(), device=w.device)
    mask = mask_p[..., inv]
    naive = mn_1d_mask(w, m, n)
    if retained_magnitude(w, mask) < retained_magnitude(w, naive):
        return naive, np.arange(perm.size)
    return mask, perm


def apply_masks(params, masks):
    """``w * mask`` over the tree, a leaf whose mask is None as it is
    (the reference's in-place hook, functional): new tensors."""
    return _tree.unflatten(_tree.paths(params), [
        p if m is None else p * m.to(p.dtype)
        for p, m in zip(_tree.leaves(params), _mask_leaves(params, masks))])


def _mask_leaves(params, masks) -> list:
    """The masks in the params' leaf order, None where a leaf has none
    (a mask tree holds None leaves, which the tree walk skips)."""
    out = []
    for path in _tree.paths(params):
        node = masks
        for key in path:
            node = node[key]
        out.append(node)
    return out


def masked_update(tx: GradientTransformation, masks) -> GradientTransformation:
    """``tx`` with its grads and updates masked, so the params keep the
    pattern (ref ``:194-207``, ASP's ``init_optimizer_for_pruning``)."""

    def init(params):
        return tx.init(apply_masks(params, masks))

    def update(grads, state, params=None):
        grads = apply_masks(grads, masks)
        updates, state = tx.update(grads, state, params)
        return apply_masks(updates, masks), state

    return GradientTransformation(init, update)


def _keystr(path) -> str:
    """A leaf's path as JAX's ``keystr`` spells it: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


class ASP:
    """ref ``asp.py`` ASP (``:210-267``), functional::

        masks = ASP.compute_sparse_masks(params)       # once
        params = ASP.apply(params, masks)
        tx = ASP.init_optimizer_for_pruning(tx, masks) # masked updates
    """

    @staticmethod
    def _eligible(path: str, leaf) -> bool:
        # ref asp.py's whitelist: weights of 2+ dims, last dim % 4 == 0
        return leaf.dim() >= 2 and leaf.shape[-1] % 4 == 0

    @staticmethod
    def compute_sparse_masks(params, pattern: str = "m4n2_1d",
                             eligible: Optional[Callable] = None,
                             allow_permutation: bool = False, **search_kw):
        """A mask for every eligible leaf (``eligible(path, leaf)``, the
        path as JAX's ``keystr``), None elsewhere; with
        ``allow_permutation`` each mask from the channel-permutation
        search (``m4n2_1d`` only)."""
        elig = eligible or ASP._eligible
        if allow_permutation and pattern != "m4n2_1d":
            raise ValueError(
                f"allow_permutation is only implemented for the m4n2_1d "
                f"pattern (got {pattern!r}); the 2d patterns constrain "
                f"both dims, so a column permutation alone cannot "
                f"preserve them")

        def mk(path, leaf):
            if not elig(_keystr(path), leaf):
                return None
            if allow_permutation:
                return permuted_mn_mask(leaf, 4, 2, **search_kw)[0]
            return create_mask(leaf, pattern)

        paths = _tree.paths(params)
        return _tree.unflatten(paths, [
            mk(p, leaf) for p, leaf in zip(paths, _tree.leaves(params))])

    @staticmethod
    def apply(params, masks):
        return apply_masks(params, masks)

    @staticmethod
    def init_optimizer_for_pruning(tx, masks):
        return masked_update(tx, masks)

    @staticmethod
    def init_model_for_pruning(params, mask_calculator: str = "m4n2_1d",
                               **kw):
        """``(params, masks)`` (ref ``asp.py:61``, functional)."""
        masks = ASP.compute_sparse_masks(params, mask_calculator, **kw)
        return apply_masks(params, masks), masks
