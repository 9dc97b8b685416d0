"""The port's contrib losses (``apex_tpu_torch.contrib.xentropy`` and
``.focal_loss``) against the JAX package's (``apex_tpu.contrib``), the
same numpy inputs on both sides, after the reference's own cases
(``tests/contrib/test_contrib.py`` ``TestXentropy``, ``TestClipFocal``).

Tolerances: fp32 losses and gradients agree to RTOL/ATOL (1e-5 / 1e-6:
the order of a row's sums); bf16 logits with ``half_to_float`` compute
in fp32 on both sides, the losses to the same bound and dlogits, rounded
to bf16 once, within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.focal_loss import focal_loss as j_focal
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as j_xent
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.contrib import focal_loss as fl
from apex_tpu_torch.contrib import xentropy as xe

RTOL, ATOL = 1e-5, 1e-6


def _logits(n, v, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int64)
    labels[::5] = 0  # padding_idx 0
    return logits, labels


def _port_xent(logits, labels, cot, **kw):
    x = torch.tensor(logits, requires_grad=True)
    loss = xe.softmax_cross_entropy_loss(x, torch.tensor(labels), **kw)
    (loss * torch.tensor(cot)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _jax_xent(logits, labels, cot, **kw):
    lab = jnp.asarray(labels.astype(np.int32))

    def f(lg):
        return j_xent(lg, lab, kw.get("smoothing", 0.0),
                      kw.get("padding_idx", 0), kw.get("half_to_float",
                                                       False))

    loss, vjp = jax.vjp(f, jnp.asarray(logits))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [0, -1])
def test_xentropy_matches_reference(smoothing, padding_idx):
    logits, labels = _logits(24, 40)
    cot = np.random.default_rng(1).standard_normal(24).astype(np.float32)
    kw = dict(smoothing=smoothing, padding_idx=padding_idx)
    got, dgot = _port_xent(logits, labels, cot, **kw)
    want, dwant = _jax_xent(logits, labels, cot, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dgot, dwant, rtol=RTOL, atol=ATOL)
    if padding_idx == 0:
        assert (got[labels == 0] == 0).all()
        assert (dgot[labels == 0] == 0).all()


def test_xentropy_is_the_plain_formula():
    """``TestXentropy.test_smoothing_and_padding`` on the port: (1 - s)
    nll + s (lse - mean logit), 0 where padded; the gradient is
    autograd's of that formula."""
    logits, labels = _logits(16, 32, seed=3)
    x = torch.tensor(logits, requires_grad=True)
    loss = xe.softmax_cross_entropy_loss(x, torch.tensor(labels),
                                         smoothing=0.2)
    loss.sum().backward()
    y = torch.tensor(logits, requires_grad=True)
    lp = torch.log_softmax(y, -1)
    lab = torch.tensor(labels)
    plain = -(0.8 * lp.gather(1, lab[:, None])[:, 0] + 0.2 * lp.mean(-1))
    plain = torch.where(lab == 0, 0.0, plain)
    plain.sum().backward()
    torch.testing.assert_close(loss, plain, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(x.grad, y.grad, rtol=RTOL, atol=ATOL)


def test_xentropy_half_to_float_bf16():
    logits, labels = _logits(12, 64, seed=5)
    logits = np.asarray(torch.tensor(logits).bfloat16().float())
    cot = np.ones(12, np.float32)
    x = torch.tensor(logits).bfloat16().requires_grad_()
    loss = xe.softmax_cross_entropy_loss(x, torch.tensor(labels),
                                         smoothing=0.1, half_to_float=True)
    loss.sum().backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    # the reference computes the same bf16 values in fp32
    want, dwant = _jax_xent(logits, labels, cot, smoothing=0.1,
                            half_to_float=True)
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    d = x.grad.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(dwant), 1e-30))) - 7)
    assert np.all(np.abs(d - dwant) <= ulp + 1e-7)


def test_xentropy_is_fp32_under_o1():
    """The ``float_function`` wrap (``xentropy.py:65-69``): under an
    active O1 policy bf16 logits are cast to fp32 first."""
    logits, labels = _logits(8, 16, seed=7)
    x = torch.tensor(logits).bfloat16()
    policy = amp.initialize(opt_level="O1").policy
    _amp_state._amp_state.handle = None
    with amp.casting(policy):
        loss = xe.softmax_cross_entropy_loss(x, torch.tensor(labels))
    assert loss.dtype == torch.float32
    plain = xe.softmax_cross_entropy_loss(x.float(), torch.tensor(labels))
    torch.testing.assert_close(loss, plain, rtol=0, atol=0)
    assert xe.SoftmaxCrossEntropyLoss()(x, torch.tensor(labels)).dtype \
        == torch.bfloat16


def _focal_inputs(seed=0, n=40, c_pad=12, c=10):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, n, c_pad)) * 2).astype(np.float32)
    targets = rng.integers(-1, c, (2, n)).astype(np.int64)
    return logits, targets, float((targets >= 0).sum()), c


@pytest.mark.parametrize("gamma,smoothing", [(0.0, 0.0), (2.0, 0.0),
                                             (2.0, 0.1), (1.5, 0.05)])
def test_focal_loss_matches_reference(gamma, smoothing):
    logits, targets, npos, c = _focal_inputs()
    x = torch.tensor(logits, requires_grad=True)
    got = fl.focal_loss(x, torch.tensor(targets), npos, c, alpha=0.25,
                        gamma=gamma, label_smoothing=smoothing)
    got.backward()

    def f(lg):
        return j_focal(lg, jnp.asarray(targets.astype(np.int32)),
                       jnp.asarray(npos), c, 0.25, gamma, smoothing)

    want, dwant = jax.value_and_grad(f)(jnp.asarray(logits))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dwant), rtol=RTOL,
                               atol=ATOL)
    # padded channels take no gradient
    assert (x.grad.numpy()[..., c:] == 0).all()


def test_focal_gamma_downweights_easy():
    """``TestClipFocal.test_focal_gamma_downweights_easy`` on the port,
    and ``max(num_positives, 1)``."""
    logits = torch.tensor([[8.0, -8.0]])
    t = torch.tensor([0])
    easy = fl.focal_loss(logits, t, 1.0, 2, 0.5, 2.0)
    hard = fl.FocalLoss()(-logits, t, 1.0, 2, 0.5, 2.0)
    assert float(easy) < float(hard) / 100
    zero = fl.FocalLoss.apply(logits, torch.tensor([-1]), 0.0, 2, 0.5, 2.0)
    one = fl.focal_loss(logits, torch.tensor([-1]), 1.0, 2, 0.5, 2.0)
    assert float(zero) == float(one)
