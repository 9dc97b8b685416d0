"""Parity of the port's fused softmax
(apex_tpu_torch.transformer.functional.fused_softmax) with the JAX
package's, forward and VJP, its Pallas whole-row kernels run in
interpret mode.

Inputs come from numpy with a fixed seed and go to both sides; the port
takes its plain versions on the CPU (the CUDA kernels are held against
them on the card). fp32 agrees to 1e-6 (summation order only); bf16 to
one bf16 ulp of each output, both sides rounding once from fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import pallas_config
from apex_tpu.transformer.functional import fused_softmax as jax_sm
from apex_tpu_torch.transformer.functional import fused_softmax as port_sm

RTOL, ATOL = 1e-5, 1e-6


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _vjp_jax(fn, x, g, dtype):
    with pallas_config.force("interpret"):
        y, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
        (dx,) = vjp(jnp.asarray(g, dtype))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _vjp_port(fn, x, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = fn(xt)
    (dx,) = torch.autograd.grad(y, (xt,), torch.from_numpy(g).to(dtype))
    assert y.dtype == dx.dtype == dtype
    return y.detach().float().numpy(), dx.float().numpy()


def _check(got, ref, bf16):
    for a, r in zip(got, ref):
        if bf16:
            assert np.all(np.abs(a - r) <= _bf16_ulp(r) + 1e-6)
        else:
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 37), (1, 8), (24, 130)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_causal_softmax_forward_and_vjp(dtype, sq, sk, scale):
    """scaled_upper_triang_masked_softmax on [3, sq, sk]; sq < sk checks
    the sk - sq diagonal offset."""
    rng = np.random.default_rng(sq * 100 + sk)
    x = (4 * rng.standard_normal((3, sq, sk))).astype(np.float32)
    g = rng.standard_normal((3, sq, sk)).astype(np.float32)
    jd, td = DT[dtype]
    ref = _vjp_jax(lambda a: jax_sm.scaled_upper_triang_masked_softmax(
        a, None, scale), x, g, jd)
    got = _vjp_port(lambda a: port_sm.scaled_upper_triang_masked_softmax(
        a, None, scale), x, g, td)
    _check(got, ref, dtype == "bfloat16")


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 37), (8, 130)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_masked_softmax_forward_and_vjp(dtype, sq, sk, scale):
    """scaled_masked_softmax on [2, 3, sq, sk] with a [2, 1, 1, sk]
    padding mask (True = masked) that masks every key of batch 1's row
    set from column 3 on, and a [2, 1, sq, sk] mask with one fully masked
    row, which the -10000 fill makes uniform."""
    rng = np.random.default_rng(sq * 10 + sk)
    x = (4 * rng.standard_normal((2, 3, sq, sk))).astype(np.float32)
    g = rng.standard_normal((2, 3, sq, sk)).astype(np.float32)
    pad = np.zeros((2, 1, 1, sk), bool)
    pad[1, ..., 3:] = True
    full = rng.random((2, 1, sq, sk)) < 0.3
    full[0, 0, sq - 1, :] = True
    jd, td = DT[dtype]
    for mask in (pad, full):
        ref = _vjp_jax(lambda a: jax_sm.scaled_masked_softmax(
            a, jnp.asarray(mask), scale), x, g, jd)
        got = _vjp_port(lambda a: port_sm.scaled_masked_softmax(
            a, torch.from_numpy(mask), scale), x, g, td)
        _check(got, ref, dtype == "bfloat16")
    y = got[0]
    np.testing.assert_allclose(y[0, :, sq - 1], 1.0 / sk, rtol=1e-2)


def test_masked_softmax_without_mask_is_plain_softmax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 9)).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 9)).astype(np.float32)
    ref = _vjp_jax(lambda a: jax_sm.scaled_masked_softmax(a, None, 0.5), x,
                   g, jnp.float32)
    before = (port_sm.causal_launches, port_sm.masked_launches)
    got = _vjp_port(lambda a: port_sm.scaled_masked_softmax(a, None, 0.5), x,
                    g, torch.float32)
    _check(got, ref, False)
    assert (port_sm.causal_launches, port_sm.masked_launches) == before


def test_long_rows_take_the_plain_version_on_the_cpu():
    """Above the whole-row limit the reference switches to its blocked
    kernels; on the CPU the port's plain version has no limit and gives
    the same rows."""
    sk = port_sm._WHOLE_ROW_MAX_SK + 8
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 2, sk)).astype(np.float32)
    with pallas_config.force("off"):
        ref = np.asarray(jax_sm.scaled_upper_triang_masked_softmax(
            jnp.asarray(x), None, 0.5))
    got = port_sm.scaled_upper_triang_masked_softmax(torch.from_numpy(x),
                                                     None, 0.5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-9)
