"""The varlen (``kv_lens``) and dropout branches of the port's flash
attention against the JAX package.

- ``_keep_mask`` equals JAX's bit for bit, seeds and positions near 2**32
  included.
- The plain forward and backward (what a CPU tensor takes; the CUDA
  kernels are held against them on the card) match ``_flash_fwd_pallas``
  and ``_flash_bwd_pallas`` in interpret mode with the same uint32 seed,
  at a ragged length of 300 with one ``kv_len = 0`` row.
- ``flash_attention`` matches JAX's with ``seed = _dropout_seed(key)``,
  output and gradients.
- The rounding of the tensor-core forward (bf16 operands, S scaled after
  the product, P rounded once to bf16 relative to the running max, O
  rescaled per 64-key tile), emulated here, stays within the tolerance
  that the card's tests hold the kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_fa
from apex_tpu_torch.ops import flash_attention as port_fa

FWD_ATOL = 2e-5           # fp32, sums in another order (as the dense tests)
BWD_ATOL, BWD_RTOL = 5e-5, 1e-4
SEQ = 300                 # ragged: no multiple of the kernels' 64
BLOCK = 100               # the Pallas blocks (its block must divide SEQ)
P_DROP = 0.2
SEED = 3_000_000_001      # above 2**31: the uint32 path of both sides
# one length a flat query row (b = 2, h = 4): a full row, an empty one,
# and ragged ones across the 64-key tile edges
ROW_LENS = np.array([300, 0, 17, 299, 150, 64, 65, 1], np.int32)

MODES = {"varlen": (True, 0.0), "dropout": (False, P_DROP),
         "varlen+dropout": (True, P_DROP)}


@pytest.mark.parametrize("p_drop", [0.1, 0.5, 0.9, 1 / 3])
def test_keep_mask_is_jax_bit_for_bit(p_drop):
    seeds = np.array([0, 1, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
                      2 ** 32 - 1], np.uint32)
    rows = np.array([0, 1, 7, 255, 2 ** 32 - 1], np.uint32)
    q_pos = np.concatenate([np.arange(24), [2 ** 31, 2 ** 32 - 1]])
    k_pos = np.concatenate([np.arange(24), [2 ** 31 + 5, 2 ** 32 - 3]])
    grid = np.meshgrid(seeds, rows, q_pos.astype(np.uint32),
                       k_pos.astype(np.uint32), indexing="ij")
    ref = np.asarray(jax_fa._keep_mask(*(jnp.asarray(a) for a in grid),
                                       p_drop))
    got = port_fa._keep_mask(*(torch.from_numpy(a.astype(np.int64))
                               for a in grid), p_drop)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1
    # plain ints broadcast as the kernels call it
    assert bool(port_fa._keep_mask(SEED, 3, 5, 7, p_drop)) == bool(
        jax_fa._keep_mask(jnp.uint32(SEED), jnp.uint32(3), jnp.uint32(5),
                          jnp.uint32(7), p_drop))


def _case(rep, d, seed):
    rng = np.random.default_rng(seed)
    bh = len(ROW_LENS)
    q = rng.standard_normal((bh, SEQ, d)).astype(np.float32)
    k = rng.standard_normal((bh // rep, SEQ, d)).astype(np.float32)
    v = rng.standard_normal((bh // rep, SEQ, d)).astype(np.float32)
    do = rng.standard_normal((bh, SEQ, d)).astype(np.float32)
    return q, k, v, do


def _jax_extras(mode):
    varlen, p_drop = MODES[mode]
    return dict(kv_lens=jnp.asarray(ROW_LENS) if varlen else None,
                p_drop=p_drop, seed=jnp.uint32(SEED) if p_drop else None)


def _port_extras(mode):
    varlen, p_drop = MODES[mode]
    return (torch.from_numpy(ROW_LENS) if varlen else None, p_drop, SEED)


CASES = [(mode, causal, rep, d) for mode in MODES for causal in (True, False)
         for rep, d in ((1, 64), (4, 128))]


@pytest.mark.parametrize("mode,causal,rep,d", CASES)
def test_plain_forward_matches_pallas_interpret(mode, causal, rep, d):
    q, k, v, _ = _case(rep, d, seed=d + rep)
    scale = d ** -0.5
    o_ref, lse_ref = jax_fa._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        BLOCK, BLOCK, interpret=True, **_jax_extras(mode))
    o, lse = port_fa._flash_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, *_port_extras(mode))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=FWD_ATOL)
    if MODES[mode][0]:  # the kv_len = 0 row: o = 0, lse = -1e30
        assert not o[1].any() and bool((lse[1] == -1e30).all())


@pytest.mark.parametrize("mode,causal,rep,d", CASES)
def test_plain_backward_matches_pallas_interpret(mode, causal, rep, d):
    """On the same (q, k, v, o, lse, do): dq, dk and dv, the masks
    selected (lse = -1e30 on the empty row makes exp(s - lse) inf)."""
    q, k, v, do = _case(rep, d, seed=d + rep + 1)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    extras = _jax_extras(mode)
    o, lse = jax_fa._flash_fwd_pallas(jq, jk, jv, causal, scale, BLOCK,
                                      BLOCK, interpret=True, **extras)
    ref = jax_fa._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal, scale,
                                   BLOCK, BLOCK, interpret=True, **extras)
    got = port_fa._flash_bwd_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal, scale, *_port_extras(mode))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 1])
def test_flash_attention_matches_jax_with_the_same_seed(causal, h_kv):
    """The public [b, s, h, d] API with kv_lens [b] and dropout: the port
    takes the int seed that JAX's ``_dropout_seed(key)`` draws; output and
    the gradients of sum(o * g) agree."""
    rng = np.random.default_rng(7 + h_kv)
    b, s, h, d = 2, 40, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    lens = np.array([40, 23], np.int32)
    key = jax.random.PRNGKey(5)
    seed = int(jax_fa._dropout_seed(key))

    def jax_loss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, causal=causal,
                                   kv_lens=jnp.asarray(lens), dropout_p=0.3,
                                   dropout_key=key)
        return jnp.sum(o * g), o

    (_, o_ref), grads_ref = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = port_fa.flash_attention(tq, tk, tv, causal=causal,
                                kv_lens=torch.from_numpy(lens),
                                dropout_p=0.3, dropout_key=seed)
    (o * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               atol=FWD_ATOL)
    assert not o[1, 23:].any()  # padded query rows are zero
    for name, t, r in zip("qkv", (tq, tk, tv), grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=f"d{name}")


def test_dropout_seed_sources():
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 2, 8)).astype(np.float32))
    first = port_fa.flash_attention(q, q, q, dropout_p=0.5, dropout_key=11)
    again = port_fa.flash_attention(q, q, q, dropout_p=0.5,
                                    dropout_key=np.uint32(11))
    other = port_fa.flash_attention(q, q, q, dropout_p=0.5, dropout_key=12)
    assert torch.equal(first, again) and not torch.equal(first, other)
    # a generator gives one seed a call, reproducible from its state
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    a, b = (port_fa.flash_attention(q, q, q, dropout_p=0.5, dropout_key=gen)
            for gen in gens)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        port_fa.flash_attention(q, q, q, dropout_p=0.5, dropout_key=2 ** 32)
    with pytest.raises(TypeError, match="dropout_key"):
        port_fa.flash_attention(q, q, q, dropout_p=0.5, dropout_key=1.5)


def _tensor_core_fwd(q, k, v, causal, scale, kv_lens, p_drop, seed):
    """The bf16 kernel's arithmetic on [bh, s, d] bf16 tensors: fp32 S of
    bf16 operands, scaled after the product; per 64-key tile the online
    (m, l) update, P (dropped) rounded once to bf16 relative to the
    running max, O rescaled by alpha; l sums the unrounded p; o rounded
    once at the end."""
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    rep = bh // bh_kv
    s = torch.einsum("grqd,gkd->grqk", q.float().reshape(bh_kv, rep, sq, d),
                     k.float()) * scale
    ok = torch.ones(bh_kv, rep, sq, sk, dtype=torch.bool)
    if causal:
        ok &= torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    if kv_lens is not None:
        ok &= port_fa._key_ok(kv_lens, rep, sk, q.device)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    keep = (port_fa._drop_masks(bh, sq, sk, rep, seed, p_drop, q.device)
            if p_drop else None)
    m = torch.full((bh_kv, rep, sq, 1), -1e30)
    l = torch.zeros(bh_kv, rep, sq, 1)
    acc = torch.zeros(bh_kv, rep, sq, d)
    for k0 in range(0, sk, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(st <= -5e29, torch.zeros_like(st),
                        torch.exp(st - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if p_drop:
            p = torch.where(keep[..., k0:k0 + 64], p / (1 - p_drop),
                            torch.zeros_like(p))
        acc = acc * alpha + torch.einsum(
            "grqk,gkd->grqd", p.to(torch.bfloat16).float(),
            v.float()[:, k0:k0 + 64])
        m = m_new
    o = acc / l.clamp(min=1e-30)
    return o.reshape(bh, sq, d).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["dense", *MODES])
@pytest.mark.parametrize("causal,rep,d", [(True, 4, 128), (False, 1, 64)])
def test_tensor_core_forward_rounding_within_card_tolerance(mode, causal,
                                                            rep, d):
    """The card holds the bf16 kernel's o to rtol = atol = 2e-2 of the
    plain version's (and lse to 1e-3, which the rounding of P does not
    touch: l sums the unrounded p)."""
    rng = np.random.default_rng(100 * rep + d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _case(rep, d, seed=int(rng.integers(1000)))[:3])
    lens, p_drop, seed = (None, 0.0, 0) if mode == "dense" else \
        _port_extras(mode)
    scale = d ** -0.5
    ref, _ = port_fa._flash_fwd_plain(q, k, v, causal, scale, lens, p_drop,
                                      seed)
    got = _tensor_core_fwd(q, k, v, causal, scale, lens, p_drop, seed)
    assert got.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert (got.float() - ref.float()).abs().max() > 0  # it rounds
