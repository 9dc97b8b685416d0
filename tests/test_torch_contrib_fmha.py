"""Parity of the port's fused MHA (``apex_tpu_torch.contrib.fmha``) with
``apex_tpu.contrib.fmha``: ``fmha``, ``fmha_packed_qkv`` and
``FMHAFun.apply`` with ``seqlens`` or ``cu_seqlens`` and dropout, output
and gradients, on the same numpy inputs. The port takes the int seed that
JAX's ``_dropout_seed(key)`` draws from the key JAX is given. fp32 on the
CPU, where the flash wrappers take their plain versions; the kernels are
held against those on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import fmha as jax_fmha
from apex_tpu.ops import flash_attention as jax_fa
from apex_tpu_torch.contrib import fmha as port_fmha
from apex_tpu_torch.ops import flash_attention as port_fa

ATOL = 2e-5               # forward, as the flash tests
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2])
def test_fmha_matches_jax(causal, h_kv):
    rng = np.random.default_rng(h_kv)
    b, s, h, d = 2, 32, 4, 16
    q, k, v = _randn(rng, b, s, h, d), _randn(rng, b, s, h_kv, d), \
        _randn(rng, b, s, h_kv, d)
    ref = jax_fmha.fmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
    got = port_fmha.fmha(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("lengths", ["seqlens", "cu_seqlens"])
@pytest.mark.parametrize("p_dropout", [0.0, 0.1])
def test_fmhafun_apply_matches_jax(lengths, p_dropout):
    """Training mode: output and d(sum(out * g))/dqkv, padded rows zero."""
    rng = np.random.default_rng(3)
    b, s, h, d = 3, 48, 2, 16
    qkv = _randn(rng, b, s, 3, h, d)
    g = _randn(rng, b, s, h, d)
    seqlens = np.array([48, 29, 1], np.int32)
    lens = {"seqlens": seqlens,
            "cu_seqlens": np.concatenate([[0], np.cumsum(seqlens)])}[lengths]
    key = jax.random.PRNGKey(9)

    def jax_loss(x):
        out = jax_fmha.FMHAFun.apply(x, **{lengths: jnp.asarray(lens)},
                                     p_dropout=p_dropout, dropout_key=key)
        return jnp.sum(out * g), out

    (_, ref), dref = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = port_fmha.FMHAFun.apply(
        x, **{lengths: torch.from_numpy(lens)}, p_dropout=p_dropout,
        dropout_key=int(jax_fa._dropout_seed(key)))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dref),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for i, n in enumerate(seqlens):
        assert not out[i, n:].any() and not x.grad[i, n:].any()


def test_fmha_packed_qkv_eval_and_dropout():
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(_randn(rng, 2, 16, 3, 4, 8))
    base = port_fmha.fmha_packed_qkv(qkv, causal=True)
    assert base.shape == (2, 16, 4, 8)
    ref = jax_fmha.fmha_packed_qkv(jnp.asarray(qkv.numpy()), causal=True)
    np.testing.assert_allclose(base.numpy(), np.asarray(ref), atol=ATOL)
    # eval: dropout is a no-op; training with a key changes the output
    same = port_fmha.FMHAFun.apply(qkv, p_dropout=0.5, is_training=False)
    torch.testing.assert_close(same, port_fmha.fmha_packed_qkv(qkv),
                               rtol=0, atol=0)
    dropped = port_fmha.fmha_packed_qkv(qkv, dropout_p=0.5, dropout_key=1)
    assert (dropped - port_fmha.fmha_packed_qkv(qkv)).abs().max() > 1e-3


def test_fmhafun_errors_match_jax():
    qkv = torch.zeros(2, 8, 3, 2, 8)
    with pytest.raises(ValueError, match="padded-dense"):
        port_fmha.FMHAFun.apply(qkv[:, :, 0])
    with pytest.raises(ValueError, match="dropout_key"):
        port_fmha.FMHAFun.apply(qkv, p_dropout=0.1)
    with pytest.raises(ValueError, match="dropout_key"):
        jax_fmha.FMHAFun.apply(jnp.zeros((2, 8, 3, 2, 8)), p_dropout=0.1)


def test_packed_qkv_reaches_the_kernels_without_a_copy(monkeypatch):
    """q, k and v reach the flash dispatch as views of qkv (same storage,
    qkv's strides), so the kernels read qkv in place on the card."""
    seen = []
    real = port_fa._flash_fwd

    def spy(q, k, v, *args):
        seen.append((q, k, v))
        return real(q, k, v, *args)

    monkeypatch.setattr(port_fa, "_flash_fwd", spy)
    qkv = torch.randn(2, 16, 3, 4, 8)
    port_fmha.FMHAFun.apply(qkv, seqlens=torch.tensor([16, 5]),
                            p_dropout=0.1, dropout_key=3)
    (q, k, v), = seen
    for i, t in enumerate((q, k, v)):
        assert t.data_ptr() == qkv[:, :, i].data_ptr()
        assert t.stride() == qkv[:, :, i].stride()
