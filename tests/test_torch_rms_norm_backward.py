"""Parity of the port's RMSNorm backward (apex_tpu_torch.ops.layer_norm)
with the JAX package's Pallas backward kernel (_rms_bwd_kernel) run in
interpret mode, and with its closed form _rms_bwd_jnp.

Inputs come from numpy with a fixed seed. On the CPU the port takes
_rms_bwd_plain, the math of the CUDA kernel; the kernel itself is held
against it on the card by chip_smoke.py and
tests/test_torch_kernels_cuda.py. Odd row counts exercise the JAX
kernel's row padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu.ops import pallas_config
from apex_tpu_torch.normalization import fused_layer_norm as port_fln
from apex_tpu_torch.ops import layer_norm as port_ln

EPS = 1e-5
# fp32: sums over h (dx) and over rows (dw) are taken in other orders
ATOL, RTOL = 2e-5, 1e-5


def _inputs(rows, h, affine, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    w = ((1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
         if affine else None)
    return x, w, dy


def _bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _jax_grads(x, w, dy, dtype):
    """(dx, dw or None) through jax.vjp of rms_norm, Pallas interpret."""
    xj = jnp.asarray(x, dtype)
    dyj = jnp.asarray(dy, dtype)
    with pallas_config.force("interpret"):
        if w is None:
            _, vjp = jax.vjp(lambda a: jax_ln.rms_norm(
                a, None, x.shape[-1], EPS), xj)
            return np.asarray(vjp(dyj)[0].astype(jnp.float32)), None
        _, vjp = jax.vjp(lambda a, b: jax_ln.rms_norm(
            a, b, x.shape[-1], EPS), xj, jnp.asarray(w, dtype))
        dx, dw = vjp(dyj)
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port_grads(x, w, dy, dtype):
    """(dx, dw or None) through torch.autograd of the port's rms_norm."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    inputs = [xt]
    wt = None
    if w is not None:
        wt = torch.from_numpy(w).to(dtype).requires_grad_()
        inputs.append(wt)
    y = port_ln.rms_norm(xt, wt, x.shape[-1], EPS)
    grads = torch.autograd.grad(y, inputs, torch.from_numpy(dy).to(dtype))
    for t, g in zip(inputs, grads):
        assert g.dtype == t.dtype and g.shape == t.shape
    out = [g.float().numpy() for g in grads]
    return out[0], (out[1] if w is not None else None)


@pytest.mark.parametrize("h", [64, 96])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_backward_fp32_matches_pallas_interpret(rows, h, affine):
    x, w, dy = _inputs(rows, h, affine, seed=rows + h)
    dx, dw = _port_grads(x, w, dy, torch.float32)
    dx_ref, dw_ref = _jax_grads(x, w, dy, jnp.float32)
    np.testing.assert_allclose(dx, dx_ref, atol=ATOL, rtol=RTOL)
    if affine:
        np.testing.assert_allclose(dw, dw_ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("h", [64, 96])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_backward_bf16_within_one_ulp(rows, h, affine):
    """bf16 x, w, dy: both sides compute in fp32 and round dx and dw once
    to bf16; their fp32 sums differ in order only, which can flip that
    rounding by one ulp."""
    x, w, dy = _inputs(rows, h, affine, seed=1000 + rows + h)
    dx, dw = _port_grads(x, w, dy, torch.bfloat16)
    dx_ref, dw_ref = _jax_grads(x, w, dy, jnp.bfloat16)
    assert np.all(np.abs(dx - dx_ref) <= _bf16_ulp(dx_ref))
    if affine:
        assert np.all(np.abs(dw - dw_ref) <= _bf16_ulp(dw_ref))


@pytest.mark.parametrize("affine", [True, False])
def test_plain_backward_matches_pallas_and_jnp(affine):
    """_rms_bwd_plain on the same (x, w, rstd, dy) as _rms_bwd_pallas in
    interpret mode and the closed form _rms_bwd_jnp."""
    x, w, dy = _inputs(33, 96, affine, seed=5)
    xj, dyj = jnp.asarray(x), jnp.asarray(dy)
    wj = None if w is None else jnp.asarray(w)
    _, rstd = jax_ln._rms_fwd_jnp(xj, wj, EPS)
    with pallas_config.force("interpret"):
        pallas = jax_ln._rms_bwd_pallas(xj, wj, rstd, dyj)
    jnp_ref = jax_ln._rms_bwd_jnp(xj, wj, rstd, dyj)
    got = port_ln._rms_bwd_plain(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        torch.from_numpy(np.asarray(rstd)), torch.from_numpy(dy))
    if not affine:
        pallas, jnp_ref, got = (pallas,), (jnp_ref,), (got,)
    for a, p, j in zip(got, pallas, jnp_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=RTOL)


def test_fused_rms_norm_is_differentiable():
    """normalization.fused_layer_norm keeps its API and now carries
    gradients, over leading dims, as the reference's does."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    import importlib

    jax_fln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")
    ref = jax.grad(lambda a, b: jnp.sum(jax_fln.fused_rms_norm_affine(
        a, b, 64) * g), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(port_fln.fused_rms_norm_affine(xt, wt, 64),
                              (xt, wt), torch.from_numpy(g))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)
    ref = jax.grad(lambda a: jnp.sum(jax_fln.fused_rms_norm(a, (64,)) * g))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(port_fln.fused_rms_norm(xt, (64,)), (xt,),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_backward_on_cpu_never_counts_a_launch():
    before = (port_ln.launches, port_ln.bwd_launches)
    x, w, dy = _inputs(7, 64, True, seed=9)
    _port_grads(x, w, dy, torch.float32)
    assert (port_ln.launches, port_ln.bwd_launches) == before
