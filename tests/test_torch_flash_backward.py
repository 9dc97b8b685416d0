"""Parity of the port's flash-attention backward
(apex_tpu_torch.ops.flash_attention) with the JAX package's Pallas
backward kernels (_bwd_dq_kernel, _bwd_dkv_kernel) run in interpret mode.

Inputs come from numpy with a fixed seed and go to both sides. On the
CPU the port's autograd backward takes _flash_bwd_plain, the arithmetic
of the two CUDA kernels in one block; the kernels themselves are held
against it on the card by chip_smoke.py and
tests/test_torch_kernels_cuda.py. Everything is fp32 here, and the two
sides sum in different orders, so gradients agree to ATOL/RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_fa
from apex_tpu.ops import pallas_config
from apex_tpu_torch.ops import flash_attention as port_fa

ATOL, RTOL = 5e-5, 1e-4

# (causal, sq, sk): 40 with causal masking and without; (33, 70) without
SHAPES = [(True, 40, 40), (False, 40, 40), (False, 33, 70)]


def _case(b, h, h_kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _flat(x):
    """[b, s, h, d] -> [b*h, s, d], heads-major as both packages flatten."""
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
@pytest.mark.parametrize("causal,sq,sk", SHAPES)
def test_plain_backward_matches_pallas_interpret(causal, sq, sk, h_kv, d):
    """_flash_bwd_plain against _flash_bwd_pallas(interpret=True) on the
    same (q, k, v, o, lse, do); rep = 4 // h_kv query heads a kv head."""
    q, k, v, g = (_flat(a) for a in _case(2, 4, h_kv, sq, sk, d, seed=d))
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jax_fa._flash_fwd_pallas(jq, jk, jv, causal, scale, 16, 16,
                                      interpret=True)
    ref = jax_fa._flash_bwd_pallas(jq, jk, jv, o, lse, jg, causal, scale,
                                   16, 16, interpret=True)
    got = port_fa._flash_bwd_plain(
        *(torch.from_numpy(np.asarray(a)) for a in (q, k, v, o, lse, g)),
        causal, scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
@pytest.mark.parametrize("causal,sq,sk", SHAPES)
def test_autograd_matches_jax_grad_interpret(causal, sq, sk, h_kv, d):
    """dq, dk, dv of the public [b, s, h, d] API: the port's
    torch.autograd against jax.grad through flash_attention with the
    Pallas kernels in interpret mode (forward and both backward
    kernels)."""
    q, k, v, g = _case(2, 4, h_kv, sq, sk, d, seed=100 + d)

    def jloss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o * jnp.asarray(g))

    with pallas_config.force("interpret"):
        ref = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = port_fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_reference(causal):
    """The closed-form backward equals torch autograd through the plain
    softmax attention (_reference_attention) on the same inputs."""
    q, k, v, g = (torch.from_numpy(_flat(a))
                  for a in _case(1, 4, 2, 24, 24, 16, seed=7))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(
        port_fa._reference_attention(q, k, v, causal, 0.25), (q, k, v), g)
    o, lse = port_fa._flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                      causal, 0.25)
    got = port_fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), o,
                                   lse, g, causal, 0.25)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=RTOL)


def test_backward_on_cpu_never_counts_a_launch():
    before = (port_fa.launches, port_fa.dq_launches, port_fa.dkv_launches)
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    port_fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert (port_fa.launches, port_fa.dq_launches,
            port_fa.dkv_launches) == before


def test_kv_lens_backward_runs_through_plain_autograd_on_cpu():
    """kv_lens stays a CPU path (plain attention, torch autograd) whose
    gradients agree with JAX's."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 16, 2, 8
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    lens = np.array([16, 9], np.int32)
    ref = jax.grad(lambda q: jnp.sum(jax_fa.flash_attention(
        q, jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_lens=jnp.asarray(lens)) * g))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    o = port_fa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                causal=True, kv_lens=torch.from_numpy(lens))
    (got,) = torch.autograd.grad(o, (tq,), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
