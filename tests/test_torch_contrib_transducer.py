"""The port's RNN-T joint and loss (``apex_tpu_torch.contrib.transducer``)
against the JAX package's, after ``tests/contrib/test_contrib.py``
``TestTransducer``: the joint (ReLU, the packed layout), the loss and
its gradient (the port's anti-diagonal wavefront with autograd against
the reference's AD through its scans), the packed input, a brute-force
lattice, and the corners where the -1e30 sentinel meets the backward
(frames past ``f_len``, labels past ``y_len``, ``y_len`` 0, one frame).

Tolerances: the loss RTOL/ATOL 1e-5 / 1e-4 (fp32 log-sum-exps in
another order over up to T + U steps), the gradient ATOL 1e-5; the
packed layout exact. Dropout's bits are not JAX's: it is held by its
properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch.contrib import transducer as tr

LOSS_RTOL, LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _case(seed, B=3, T=6, U=4, V=8, f_len=(6, 5, 4), y_len=(4, 3, 2)):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    targets = rng.randint(1, V, (B, U)).astype(np.int64)
    return logits, targets, np.array(f_len), np.array(y_len)


def _port(logits, targets, f_len, y_len, **kw):
    x = torch.tensor(logits, requires_grad=True)
    loss = tr.transducer_loss(x, torch.tensor(targets), torch.tensor(f_len),
                              torch.tensor(y_len), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _ref(logits, targets, f_len, y_len, **kw):
    args = [jnp.asarray(a.astype(np.int32)) for a in (targets, f_len,
                                                      y_len)]
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}

    def f(lg):
        return jtr.transducer_loss(lg, *args, **kw)

    loss, vjp = jax.vjp(jax.jit(f), jnp.asarray(logits))
    return np.asarray(loss), np.asarray(vjp(jnp.ones_like(loss))[0])


CASES = {
    "padded": dict(seed=0),
    "full": dict(seed=1, f_len=(6, 6, 6), y_len=(4, 4, 4)),
    "y_len_0_and_one_frame": dict(seed=2, f_len=(1, 6, 3), y_len=(0, 4, 0)),
    "long": dict(seed=3, B=2, T=23, U=9, V=5, f_len=(23, 17),
                 y_len=(9, 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_match_reference(case):
    logits, targets, f_len, y_len = _case(**CASES[case])
    got, dgot = _port(logits, targets, f_len, y_len)
    want, dwant = _ref(logits, targets, f_len, y_len)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert np.isfinite(dgot).all()
    np.testing.assert_allclose(dgot, dwant, rtol=1e-4, atol=GRAD_ATOL)
    # cells off each sequence's lattice take no gradient
    for b in range(len(f_len)):
        assert (dgot[b, f_len[b]:] == 0).all()
        assert (dgot[b, :, y_len[b] + 1:] == 0).all()


def test_loss_matches_bruteforce():
    logits, targets, f_len, y_len = _case(0)
    got, _ = _port(logits, targets, f_len, y_len)
    lp = torch.log_softmax(torch.tensor(logits, dtype=torch.float64),
                           -1).numpy()

    def brute(lp, tg, T, U):
        alpha = np.full((T, U + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(T):
            for u in range(U + 1):
                c = []
                if t > 0:
                    c.append(alpha[t - 1, u] + lp[t - 1, u, 0])
                if u > 0:
                    c.append(alpha[t, u - 1] + lp[t, u - 1, tg[u - 1]])
                if c:
                    alpha[t, u] = np.logaddexp.reduce(c)
        return -(alpha[T - 1, U] + lp[T - 1, U, 0])

    want = [brute(lp[b], targets[b], f_len[b], y_len[b]) for b in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _pack(padded, f_len, g_len):
    return np.concatenate([np.asarray(padded[b, :f_len[b], :g_len[b]])
                           .reshape(f_len[b] * g_len[b], -1)
                           for b in range(padded.shape[0])], axis=0)


def test_packed_loss_and_grad_match_reference():
    logits, targets, f_len, y_len = _case(1)
    g_len = y_len + 1
    offset = np.cumsum(f_len * g_len)
    packed = _pack(logits, f_len, g_len)
    kw = dict(packed_input=True, batch_offset=offset, max_f_len=6)
    got, dgot = _port(packed, targets, f_len, y_len,
                      **{**kw, "batch_offset": torch.tensor(offset)})
    want, dwant = _ref(packed, targets, f_len, y_len, **kw)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(dgot, dwant, rtol=1e-4, atol=GRAD_ATOL)
    padded, _ = _port(logits, targets, f_len, y_len)
    np.testing.assert_allclose(got, padded, rtol=1e-6, atol=1e-5)
    assert np.abs(dgot).sum() > 0


@pytest.mark.parametrize("relu", [False, True])
def test_joint_and_packed_layout_match_reference(relu):
    rng = np.random.default_rng(4)
    f = rng.standard_normal((3, 5, 8)).astype(np.float32)
    g = rng.standard_normal((3, 4, 8)).astype(np.float32)
    f_len, g_len = np.array([5, 3, 4]), np.array([4, 2, 3])
    offset = np.cumsum(f_len * g_len)
    h = tr.TransducerJoint(relu=relu)(torch.tensor(f), torch.tensor(g))
    jh = jtr.TransducerJoint(relu=relu)(jnp.asarray(f), jnp.asarray(g))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    packed = tr.TransducerJoint(pack_output=True, relu=relu)(
        torch.tensor(f), torch.tensor(g), torch.tensor(f_len),
        torch.tensor(g_len), batch_offset=torch.tensor(offset),
        packed_batch=int(offset[-1]))
    jpacked = jtr.TransducerJoint(pack_output=True, relu=relu)(
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(f_len),
        jnp.asarray(g_len), batch_offset=jnp.asarray(offset),
        packed_batch=int(offset[-1]))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(packed.numpy(),
                                  _pack(h.numpy(), f_len, g_len))
    with pytest.raises(ValueError, match="batch_offset"):
        tr.transducer_joint(torch.tensor(f), torch.tensor(g),
                            pack_output=True)


def test_joint_dropout_properties():
    """Kept share near 1 - p, kept values scaled by 1 / (1 - p), dropped
    ones exactly 0; the same generator seed gives the same mask."""
    torch.manual_seed(0)
    f, g = torch.randn(2, 50, 16) + 3.0, torch.randn(2, 20, 16) + 3.0
    joint = tr.TransducerJoint(dropout=True, dropout_prob=0.25)
    h = joint(f, g, generator=torch.Generator().manual_seed(5))
    plain = f[:, :, None] + g[:, None]
    kept = h != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(h[kept], plain[kept] / 0.75, rtol=1e-6,
                               atol=0)
    again = joint(f, g, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(h, again, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        joint(f, g)


def test_loss_class_shape():
    logits, targets, f_len, y_len = _case(5)
    loss = tr.TransducerLoss()(torch.tensor(logits), torch.tensor(targets),
                               torch.tensor(f_len), torch.tensor(y_len))
    want, _ = _ref(logits, targets, f_len, y_len)
    np.testing.assert_allclose(loss.numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert loss.dtype == torch.float32
