"""Parity of the port's precision helpers (apex_tpu_torch.ops.precision)
with the JAX package's: the fp32-accumulator contractions, the fp8
quantizers, and matmul_fp8 / matmul_fp8_stats / einsum_fp8 forward and
backward (the cotangent quantized to E5M2, the probe's gradient its
amax) against ``jax.value_and_grad``. Inputs from numpy with fixed seeds.

Tolerances: the fp8 operands are equal bit for bit on both sides (the
cast test's contract), and fp8 products are exact in fp32, so the
results differ only by the order of the fp32 sums: rtol 1e-5 (atol 1e-6)
for fp32 results, one bf16 ulp for bf16 results. amaxes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import precision as jp
from apex_tpu_torch.ops import precision as tp

RTOL, ATOL = 1e-5, 1e-6
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_exact(x):
    return torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16).float().numpy()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, bf16=False):
    got, ref = _np(got), _np(ref)
    if bf16:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp + 1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _operands(a_shape, b_shape, seed):
    rng = np.random.default_rng(seed)
    a = _bf16_exact(rng.standard_normal(a_shape) * 3.0)
    b = _bf16_exact(rng.standard_normal(b_shape) * 0.05)
    c = _bf16_exact(rng.standard_normal(a_shape[:-1] + b_shape[-1:]))
    return a, b, c


def test_constants_match():
    assert (tp.F8_E4M3_MAX, tp.F8_E5M2_MAX) == (jp.F8_E4M3_MAX,
                                                jp.F8_E5M2_MAX)
    assert str(tp.F8_E4M3).endswith("e4m3fn")
    assert str(tp.F8_E5M2).endswith("e5m2")


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("keep_acc", [False, True])
def test_fp32acc_contractions_match_jax(dtype, keep_acc):
    """The JAX side runs on fp32 operands: jax's CPU dot refuses bf16 x
    bf16 = f32. The operands are exact in bf16, so that is the same fp32
    accumulation, and the bf16 result is its rounding."""
    a, b, _ = _operands((3, 5, 24), (24, 16), seed=1)
    td = DT[dtype][1]
    jd = jnp.float32
    ref = jp.matmul_fp32acc(jnp.asarray(a, jd), jnp.asarray(b, jd),
                            keep_acc=keep_acc)
    got = tp.matmul_fp32acc(torch.from_numpy(a).to(td),
                            torch.from_numpy(b).to(td), keep_acc=keep_acc)
    want = torch.float32 if keep_acc else td
    assert got.dtype == want
    _close(got, ref, bf16=dtype == "bfloat16" and not keep_acc)
    ref = jp.einsum_fp32acc("bsk,kn->bns", jnp.asarray(a, jd),
                            jnp.asarray(b, jd))
    got = tp.einsum_fp32acc("bsk,kn->bns", torch.from_numpy(a).to(td),
                            torch.from_numpy(b).to(td))
    assert got.dtype == td
    _close(got, ref, bf16=dtype == "bfloat16")


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantizers_match_jax(fmt):
    x = _bf16_exact(np.random.default_rng(2).standard_normal((7, 33)) * 200)
    jd = jp.F8_E4M3 if fmt == "e4m3" else jp.F8_E5M2
    td = tp.F8_E4M3 if fmt == "e4m3" else tp.F8_E5M2
    y_ref, amax_ref = jp.quantize_fp8_stats(jnp.asarray(x), 0.9, jd)
    y, amax = tp.quantize_fp8_stats(torch.from_numpy(x), 0.9, td)
    np.testing.assert_array_equal(y.view(torch.uint8).numpy(),
                                  np.asarray(y_ref).view(np.uint8))
    assert float(amax) == float(amax_ref) == float(
        tp.fp8_amax(torch.from_numpy(x))) == float(jp.fp8_amax(x))
    np.testing.assert_array_equal(
        tp.quantize_fp8(torch.from_numpy(x), 0.9, td).view(torch.uint8),
        torch.from_numpy(np.array(jp.quantize_fp8(jnp.asarray(x), 0.9,
                                                  jd)).view(np.uint8)))


def _jax_fp8(fn, a, b, c, sa, sb, gs, jd):
    """value_and_grad of sum(fn(...) * c) in a, b and the probe."""
    def loss(a_, b_, probe):
        y = fn(a_, b_, sa, sb, grad_scale=gs, grad_probe=probe)
        return jnp.sum(y.astype(jnp.float32) * c), y

    (val, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(a, jd), jnp.asarray(b, jd), jnp.zeros([], jnp.float32))
    return y, val, grads


def _port_fp8(fn, a, b, c, sa, sb, gs, td):
    at = torch.from_numpy(a).to(td).requires_grad_()
    bt = torch.from_numpy(b).to(td).requires_grad_()
    probe = torch.zeros((), requires_grad=True)
    y = fn(at, bt, sa, sb, grad_scale=gs, grad_probe=probe)
    loss = torch.sum(y.float() * torch.from_numpy(c))
    grads = torch.autograd.grad(loss, (at, bt, probe))
    return y, loss, grads


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("scales", [(1.0, 1.0, 1.0), (1.3, 25.0, 0.7)])
def test_matmul_fp8_values_and_grads_match_jax(dtype, scales):
    """a [2, 6, 32] with leading dims, b [32, 48]; the cotangent c is
    fixed, so both sides quantize the same g."""
    a, b, c = _operands((2, 6, 32), (32, 48), seed=3)
    sa, sb, gs = scales
    jd, td = DT[dtype]
    y_ref, val_ref, g_ref = _jax_fp8(jp.matmul_fp8, a, b, c, sa, sb, gs, jd)
    y, val, g = _port_fp8(tp.matmul_fp8, a, b, c, sa, sb, gs, td)
    bf16 = dtype == "bfloat16"
    assert y.dtype == td and y.shape == (2, 6, 48)
    _close(y, y_ref, bf16)
    for got, ref in zip(g[:2], g_ref[:2]):
        assert got.dtype == td
        _close(got, ref, bf16)
    # the probe's gradient is the cotangent's amax, exactly
    assert float(g[2]) == float(g_ref[2]) == float(np.abs(c).max())


def test_matmul_fp8_stats_amaxes_and_out_dtype():
    a, b, _ = _operands((5, 32), (32, 16), seed=4)
    y_ref, amax_a, amax_b = jp.matmul_fp8_stats(
        jnp.asarray(a), jnp.asarray(b), 2.0, 8.0, out_dtype=jnp.bfloat16)
    y, ta, tb = tp.matmul_fp8_stats(torch.from_numpy(a), torch.from_numpy(b),
                                    2.0, 8.0, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    _close(y, y_ref, bf16=True)
    assert (float(ta), float(tb)) == (float(amax_a), float(amax_b))
    with pytest.raises(ValueError, match="2-D"):
        tp.matmul_fp8(torch.from_numpy(a), torch.zeros(2, 32, 16), 1.0, 1.0)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_einsum_fp8_values_and_grads_match_jax(dtype):
    a, b, _ = _operands((4, 3, 16), (16, 24), seed=5)
    c = _bf16_exact(np.random.default_rng(6).standard_normal((3, 4, 24)))
    jd, td = DT[dtype]

    def jfn(a_, b_, sa, sb, **kw):
        return jp.einsum_fp8("bsk,kn->sbn", a_, b_, sa, sb, **kw)

    def tfn(a_, b_, sa, sb, **kw):
        return tp.einsum_fp8("bsk,kn->sbn", a_, b_, sa, sb, **kw)

    y_ref, _, g_ref = _jax_fp8(jfn, a, b, c, 0.8, 3.0, 2.0, jd)
    y, _, g = _port_fp8(tfn, a, b, c, 0.8, 3.0, 2.0, td)
    bf16 = dtype == "bfloat16"
    _close(y, y_ref, bf16)
    for got, ref in zip(g[:2], g_ref[:2]):
        _close(got, ref, bf16)
    assert float(g[2]) == float(g_ref[2])


def test_fp8_einsum_equals_matmul():
    a, b, _ = _operands((6, 32), (32, 16), seed=7)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    torch.testing.assert_close(tp.einsum_fp8("ij,jk->ik", at, bt, 1.0, 1.0),
                               tp.matmul_fp8(at, bt, 1.0, 1.0), rtol=RTOL,
                               atol=ATOL)
