"""Parity of the port's fp8 cast-and-scale
(apex_tpu_torch.ops.fp8_cast_kernel) with the JAX package's: its Pallas
kernel run in interpret mode and its jnp version, on the same inputs
(numpy, fixed seeds).

Tolerance: none. y is one fp32 product, an exact clip and one rounding
to fp8, so every finite value must be equal bit for bit; NaN is compared
by position (torch and ml_dtypes encode E5M2's NaN differently), and
amax, a max, must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import fp8_cast_kernel as jax_cast
from apex_tpu.tuning import search_space
from apex_tpu_torch.ops import fp8_cast_kernel as port_cast

FORMATS = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0),
           "e5m2": (jnp.float8_e5m2, torch.float8_e5m2, 57344.0)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, spread=300.0):
    """Mixed magnitudes (normal times a log-uniform factor), exact in bf16
    so both frameworks start from the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-12, 0, shape))
    x = torch.from_numpy((x * spread).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _jax_side(x, scale, fmt, dtype, interpret):
    jfmt, _, fmax = FORMATS[fmt]
    xj = jnp.asarray(x, DTYPES[dtype][0])
    if interpret:
        rows, cols = search_space.default_fp8_cast_geometry(x.size)
        y, amax = jax_cast._cast_and_scale_pallas(
            xj, jnp.float32(scale), dtype=jnp.dtype(jfmt), fmax=fmax,
            block_rows=rows, cols=cols, interpret=True)
    else:
        y, amax = jax_cast._cast_and_scale_jnp(xj, jnp.float32(scale), jfmt,
                                               fmax)
    return (np.asarray(y).view(np.uint8),
            np.isnan(np.asarray(y.astype(jnp.float32))), np.asarray(amax))


def _port_side(x, scale, fmt, dtype, scale_as_tensor=False):
    _, tfmt, fmax = FORMATS[fmt]
    xt = torch.from_numpy(x).to(DTYPES[dtype][1])
    s = torch.tensor(scale) if scale_as_tensor else scale
    y, amax = port_cast.cast_and_scale_stats(xt, s, tfmt, fmax)
    assert y.dtype == tfmt and y.shape == xt.shape
    assert amax.dtype == torch.float32 and amax.dim() == 0
    return (y.view(torch.uint8).numpy(), torch.isnan(y.float()).numpy(),
            amax.numpy())


def _assert_same(got, ref):
    bits, nan, amax = got
    ref_bits, ref_nan, ref_amax = ref
    np.testing.assert_array_equal(nan, ref_nan)
    np.testing.assert_array_equal(bits[~nan], ref_bits[~ref_nan])
    if np.isnan(ref_amax):
        assert np.isnan(amax)
    else:
        assert amax == ref_amax


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1,), (5000,), (7919,), (64, 96)],
                         ids=["n1", "n5000", "prime", "2d"])
@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "jnp"])
def test_cast_bits_equal_jax(fmt, dtype, shape, interpret):
    """The scale 1.7 pushes the largest values past E4M3's 448, so the
    E4M3 cases saturate too."""
    x = _inputs(shape, seed=sum(shape))
    ref = _jax_side(x, 1.7, fmt, dtype, interpret)
    _assert_same(_port_side(x, 1.7, fmt, dtype), ref)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_saturation_inf_and_nan_like_jax(fmt):
    """Values past fmax and +-inf clamp to +-fmax; a NaN stays NaN in y
    and makes amax NaN, as jnp.clip and jnp.max propagate it."""
    _, _, fmax = FORMATS[fmt]
    x = np.array([1e9, -1e9, np.inf, -np.inf, fmax * 0.99, 3.0, np.nan,
                  -0.0], np.float32)
    for interpret in (True, False):
        ref = _jax_side(x, 2.0, fmt, "float32", interpret)
        _assert_same(_port_side(x, 2.0, fmt, "float32"), ref)
    _, _, amax = _port_side(x[:6], 2.0, fmt, "float32")
    assert amax == np.inf
    got = torch.from_numpy(x[:4])
    y, _ = port_cast.cast_and_scale_stats(got, 1.0, FORMATS[fmt][1], fmax)
    assert y.float().tolist() == [fmax, -fmax, fmax, -fmax]


def test_tensor_scale_equals_number_scale():
    x = _inputs((333,), seed=4)
    for fmt in FORMATS:
        a = _port_side(x, 0.37, fmt, "bfloat16")
        b = _port_side(x, 0.37, fmt, "bfloat16", scale_as_tensor=True)
        _assert_same(a, b)


def test_scalar_and_empty_take_the_plain_path_like_jax():
    """A 0-dim x is cast as the reference's jnp version does; an empty one
    raises on both sides (a max of nothing has no value). On the card
    both reach the kernel's wrapper, which launches for the 0-dim x and
    raises for the empty one."""
    x = np.array(-500.0, np.float32)
    ref = _jax_side(x, 1.0, "e4m3", "float32", False)
    got = _port_side(x, 1.0, "e4m3", "float32")
    _assert_same(got, ref)
    assert got[2] == 500.0
    with pytest.raises(ValueError):
        jax_cast.cast_and_scale_stats(jnp.zeros((0,)), 1.0,
                                      jnp.float8_e4m3fn, 448.0)
    with pytest.raises(RuntimeError):
        port_cast.cast_and_scale_stats(torch.zeros(0), 1.0,
                                       torch.float8_e4m3fn, 448.0)


def test_cpu_tensors_never_count_launches():
    before = port_cast.launches
    port_cast.cast_and_scale_stats(torch.ones(100), 1.0,
                                   torch.float8_e4m3fn, 448.0)
    assert port_cast.launches == before


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (64, 96), (130, 17)],
                         ids=["1x1", "3x5", "64x96", "130x17"])
def test_col_major_cast_bits_equal_jax(fmt, shape):
    """``col_major=True`` lays y out column-major (strides (1, rows)) with
    the values of the reference's cast, bit for bit, and the same amax."""
    x = _inputs(shape, seed=7 + sum(shape))
    ref = _jax_side(x, 1.7, fmt, "bfloat16", False)
    _, tfmt, fmax = FORMATS[fmt]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y, amax = port_cast.cast_and_scale_stats(xt, 1.7, tfmt, fmax,
                                             col_major=True)
    assert y.shape == xt.shape and y.stride() == (1, shape[0])
    _assert_same((y.contiguous().view(torch.uint8).numpy(),
                  torch.isnan(y.float()).numpy(), amax.numpy()), ref)


@pytest.mark.parametrize("shape", [(), (6,), (2, 3, 4)])
def test_col_major_cast_needs_a_matrix(shape):
    with pytest.raises(ValueError, match="2-D"):
        port_cast.cast_and_scale_stats(torch.ones(shape), 1.0,
                                       torch.float8_e4m3fn, 448.0,
                                       col_major=True)
