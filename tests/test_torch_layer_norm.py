"""Parity of the port's RMSNorm forward (apex_tpu_torch.ops.layer_norm)
with the JAX package's Pallas kernel run in interpret mode.

Inputs come from numpy with a fixed seed and go to both sides. On the
CPU the port takes its plain version, the same math the CUDA kernel
computes; the kernel itself is held against that plain version on the
card by chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu.ops import pallas_config
from apex_tpu_torch.normalization import fused_layer_norm as port_fln
from apex_tpu_torch.ops import layer_norm as port_ln

EPS = 1e-5


def _inputs(rows, h, affine, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32) if affine \
        else None
    return x, w


def _bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _jax_rms(x, w, dtype):
    xj = jnp.asarray(x, dtype)
    wj = None if w is None else jnp.asarray(w, dtype)
    with pallas_config.force("interpret"):
        y = jax_ln.rms_norm(xj, wj, x.shape[-1], EPS)
    return np.asarray(y.astype(jnp.float32))


def _port_rms(x, w, dtype):
    xt = torch.from_numpy(x).to(dtype)
    wt = None if w is None else torch.from_numpy(w).to(dtype)
    return port_ln.rms_norm(xt, wt, x.shape[-1], EPS).float().numpy()


@pytest.mark.parametrize("h", [64, 96])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_fp32_matches_pallas_interpret(rows, h, affine):
    x, w = _inputs(rows, h, affine)
    np.testing.assert_allclose(_port_rms(x, w, torch.float32),
                               _jax_rms(x, w, jnp.float32),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("h", [64, 96])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_bf16_within_one_ulp(rows, h, affine):
    """Both sides compute in fp32 and round once to bf16; the fp32 sums
    differ in order only, which can flip that rounding by one ulp."""
    x, w = _inputs(rows, h, affine, seed=1)
    ref = _jax_rms(x, w, jnp.bfloat16)
    got = _port_rms(x, w, torch.bfloat16)
    assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("affine", [True, False])
def test_rstd_matches_rms_fwd_jnp(affine):
    x, w = _inputs(33, 96, affine, seed=2)
    _, rstd_ref = jax_ln._rms_fwd_jnp(
        jnp.asarray(x), None if w is None else jnp.asarray(w), EPS)
    y, rstd = port_ln._rms_fwd_plain(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        EPS)
    assert rstd.shape == (33, 1) and rstd.dtype == torch.float32
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref),
                               rtol=1e-5)


def test_fused_rms_norm_functional_api():
    """normalization.fused_layer_norm routes through ops.rms_norm with the
    reference's 1e-6 default eps and leading dims kept."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    # the package re-exports a function of the module's name
    jax_fln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")

    got = port_fln.fused_rms_norm_affine(torch.from_numpy(x),
                                         torch.from_numpy(w), 64)
    ref = jax_fln.fused_rms_norm_affine(jnp.asarray(x), jnp.asarray(w), 64)
    assert tuple(got.shape) == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    got = port_fln.fused_rms_norm(torch.from_numpy(x), (64,))
    ref = jax_fln.fused_rms_norm(jnp.asarray(x), (64,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_cpu_path_never_counts_a_launch():
    before = port_ln.launches
    x, w = _inputs(7, 64, True)
    _port_rms(x, w, torch.float32)
    assert port_ln.launches == before


def test_normalized_shape_mismatch_is_loud():
    with pytest.raises(ValueError, match="normalized_shape"):
        port_ln.rms_norm(torch.zeros(3, 8), None, (4,))
