"""Parity of the port's RNNs (apex_tpu_torch.rnn) with the JAX
package's, from the JAX model's own params carried across
(``rnn.params_from_numpy``) and the same numpy inputs: all five cells,
stacked, bidirectional, ``batch_first`` and ``output_size``; outputs and
final states within 1e-5, gradients through the port against
``jax.grad`` of the reference within 1e-4 relative L2 per leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import rnn as jrnn
from apex_tpu.rnn import cells as jcells
from apex_tpu_torch import _tree
from apex_tpu_torch import rnn as prnn
from apex_tpu_torch.rnn import cells as pcells

ATOL = 1e-5
GRAD_REL = 1e-4
SEQ, BATCH, IN, HID = 5, 3, 4, 6

CASES = {
    "lstm": ("LSTM", dict()),
    "mlstm": ("mLSTM", dict()),
    "gru": ("GRU", dict()),
    "relu": ("ReLU", dict()),
    "tanh": ("Tanh", dict()),
    "lstm_stacked": ("LSTM", dict(num_layers=2)),
    "mlstm_stacked_bidir": ("mLSTM", dict(num_layers=2, bidirectional=True)),
    "gru_bidir_batch_first": ("GRU", dict(bidirectional=True,
                                          batch_first=True)),
    "lstm_output_size": ("LSTM", dict(num_layers=2, output_size=3)),
    "mlstm_output_size_bidir": ("mLSTM", dict(output_size=3,
                                              bidirectional=True)),
    "tanh_no_bias": ("Tanh", dict(bias=False, num_layers=2)),
}


def _models(mode, kw):
    jm = getattr(jrnn, mode)(IN, HID, seed=3, **kw)
    pm = getattr(prnn, mode)(IN, HID, device="cpu", **kw)
    pm.params = prnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu")
    return jm, pm


def _x(kw, seed=0):
    shape = (BATCH, SEQ, IN) if kw.get("batch_first") else (SEQ, BATCH, IN)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_and_final_states_match_jax(case):
    mode, kw = CASES[case]
    jm, pm = _models(mode, kw)
    x = _x(kw)
    jout, jfin = jm(jnp.asarray(x))
    out, fin = pm(torch.from_numpy(x))
    assert tuple(out.shape) == jout.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    jf, pf = _leaves_np(jfin), [t.numpy() for t in _tree.leaves(fin)]
    assert len(jf) == len(pf)
    for a, b in zip(pf, jf):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_grad(case):
    """d/dparams and d/dx of <outputs, c> + <h_final, c'>: the port's
    autograd against ``jax.grad`` of the reference."""
    mode, kw = CASES[case]
    jm, pm = _models(mode, kw)
    x = _x(kw, seed=1)
    rng = np.random.default_rng(2)
    jout, _ = jm(jnp.asarray(x))
    cot = rng.standard_normal(jout.shape).astype(np.float32)

    def jloss(params, x):
        out, fin = jm(x, params=params)
        h_last = jax.tree_util.tree_leaves(fin)[0]
        return jnp.sum(out * cot) + 0.5 * jnp.sum(h_last ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jm.params, jnp.asarray(x))
    params = _tree.map_leaves(lambda t: t.clone().requires_grad_(True),
                              {str(i): lp for i, lp in enumerate(pm.params)})
    xt = torch.from_numpy(x).requires_grad_(True)
    out, fin = pm(xt, params=[params[str(i)] for i in range(len(params))])
    h_last = _tree.leaves(fin)[0]
    loss = (out * torch.from_numpy(cot)).sum() + 0.5 * (h_last ** 2).sum()
    loss.backward()
    want = jax.tree_util.tree_leaves(jgp)
    got = [t.grad for t in _tree.leaves(
        [params[str(i)] for i in range(len(params))])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), np.asarray(w)) <= GRAD_REL
    assert _rel_l2(xt.grad.numpy(), np.asarray(jgx)) <= GRAD_REL


@pytest.mark.parametrize("name", ["lstm_cell", "mlstm_cell", "gru_cell",
                                  "relu_cell", "tanh_cell"])
def test_one_cell_step_matches_jax(name):
    mode = {"lstm_cell": "LSTM", "mlstm_cell": "mLSTM", "gru_cell": "GRU",
            "relu_cell": "ReLU", "tanh_cell": "Tanh"}[name]
    _, mult, n_states, extra = jcells.CELLS[mode]
    assert pcells.CELLS[mode][1:] == (mult, n_states, extra)
    jp = jcells.init_cell_params(jax.random.PRNGKey(0), IN, HID, mult,
                                 extra_m=extra)
    pp = _tree.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                          jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(4)
    carry = tuple(rng.standard_normal((BATCH, HID)).astype(np.float32)
                  for _ in range(n_states))
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    (jc, jy) = getattr(jcells, name)(jp, tuple(map(jnp.asarray, carry)),
                                     jnp.asarray(x))
    (pc, py) = getattr(pcells, name)(pp, tuple(map(torch.from_numpy, carry)),
                                     torch.from_numpy(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=ATOL)
    for a, b in zip(pc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_init_draws_the_references_layout_and_bound():
    p = pcells.init_cell_params(torch.Generator().manual_seed(0), IN, 16, 4,
                                extra_m=True, output_size=8, device="cpu")
    jp = jcells.init_cell_params(jax.random.PRNGKey(0), IN, 16, 4,
                                 extra_m=True, output_size=8)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for v in p.values():
        assert float(v.abs().max()) <= 16 ** -0.5
    m = prnn.mLSTM(IN, 16, num_layers=2, bidirectional=True, device="cpu")
    assert set(m.params[1]) == {"fwd", "rev"}
    assert m.params[1]["fwd"]["w_ih"].shape == (64, 32)


def test_dropout_needs_a_generator_and_applies_between_layers():
    m = prnn.LSTM(IN, HID, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(_x({}))
    with pytest.raises(ValueError, match="generator"):
        m(x)
    a, _ = m(x, generator=torch.Generator().manual_seed(1))
    b, _ = m(x, generator=torch.Generator().manual_seed(1))
    c, _ = m(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    m.dropout = 0.0
    plain, _ = m(x)
    assert not torch.equal(a, plain)
    one = prnn.LSTM(IN, HID, num_layers=1, dropout=0.5, device="cpu")
    out, _ = one(x)  # no layer after the last: no dropout, no generator


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prnn.mLSTM(IN, HID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcells.init_cell_params(torch.Generator(), IN, HID, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prnn.params_from_numpy([{"w_ih": np.zeros((4, 2), np.float32)}])
