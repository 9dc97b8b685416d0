"""Parity of the port's flash-attention forward
(apex_tpu_torch.ops.flash_attention) with the JAX package's Pallas
kernel run in interpret mode, and of the public [b, s, h, d] API.

On the CPU the port takes its plain version, the kernel's masked online
softmax computed in one block; chip_smoke.py holds the CUDA kernel
against that plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_fa
from apex_tpu_torch.ops import flash_attention as port_fa

ATOL = 2e-5  # fp32: the two sides sum in different orders


def _qkv(bh, bh_kv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh_kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh_kv, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
def test_flash_fwd_matches_pallas_interpret(causal, h_kv):
    """(o, lse) of the forward's dispatcher on [b, s, h, d] (the plain
    version on the CPU) against _flash_fwd_pallas in interpret mode on the
    heads-major [b*h, s, d] layout; sk = 40 with block 32 leaves a ragged
    key range."""
    b, h, d = 2, 4, 16
    sq = 40 if causal else 24
    sk = 40
    q, k, v = _qkv(b * h, b * h_kv, sq, sk, d)
    scale = d ** -0.5
    o_ref, lse_ref = jax_fa._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        32, 32, interpret=True)

    def seq_major(a, heads):  # [b*heads, s, d] -> [b, s, heads, d]
        return torch.from_numpy(a).reshape(b, heads, -1, d).transpose(1, 2)

    o, lse = port_fa._flash_fwd(seq_major(q, h), seq_major(k, h_kv),
                                seq_major(v, h_kv), causal, scale)
    assert o.shape == (b, sq, h, d) and lse.shape == (b * h, sq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(port_fa._heads_major(o).numpy(),
                               np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_reference_attention(causal):
    q, k, v = _qkv(8, 2, 40, 40, 16, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o, _ = port_fa._flash_fwd_plain(*args, causal, 0.25)
    ref = port_fa._reference_attention(*args, causal, 0.25)
    jref = jax_fa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, 0.25)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=ATOL)


@pytest.mark.parametrize("h_kv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_public_api_matches_jax(causal, h_kv):
    """flash_attention on [b, s, h, d] with GQA: heads-major flatten,
    query head g*rep+r reads kv head g, as in the reference."""
    rng = np.random.default_rng(2)
    b, s, h, d = 2, 24, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    ref = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = port_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_kv_lens_on_cpu_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 16, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    lens = np.array([16, 9], np.int32)
    ref = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 kv_lens=jnp.asarray(lens))
    got = port_fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_argument_errors_are_loud():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_fa.flash_attention(q, torch.zeros(1, 4, 2, 8),
                                torch.zeros(1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="dropout"):
        port_fa.flash_attention(q, q, q, dropout_p=0.1)
    # eval mode: dropout is a no-op, as in the reference
    port_fa.flash_attention(q, q, q, dropout_p=0.1, deterministic=True)


def test_cpu_path_never_counts_a_launch():
    before = port_fa.launches
    q = torch.zeros(1, 4, 2, 8)
    port_fa.flash_attention(q, q, q, causal=True)
    assert port_fa.launches == before
