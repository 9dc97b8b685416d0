"""Parity of the port's LayerNorm forward and backward
(apex_tpu_torch.ops.layer_norm) with the JAX package's Pallas kernels run
in interpret mode (``_ln_fwd_pallas``, ``_ln_bwd_pallas``).

Inputs come from numpy with a fixed seed and go to both sides. On the CPU
the port takes its plain versions, the same math the CUDA kernels
compute; the kernels themselves are held against those plain versions on
the card by chip_smoke.py and tests/test_torch_kernels_cuda.py.

Tolerances: fp32 agrees to 1e-5 relative (summation order only). In bf16
both sides compute in fp32 and round each output once, so they agree to
one bf16 ulp of each value; a backward value that is a difference of
near-equal fp32 terms may also carry fp32 noise of order 1e-6 of the
output's scale, which BF16_FLOOR covers.
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
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
BF16_FLOOR = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, h, affine, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, h)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    if not affine:
        return x, dy, None, None
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, dy, w, b


def _bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, ref, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=FP32_ATOL,
                                   err_msg=what)
        return
    err = np.abs(got - ref)
    bound = _bf16_ulp(ref) + BF16_FLOOR * np.abs(ref).max()
    assert np.all(err <= bound), (what, float((err - bound).max()))


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, DTYPES[dtype][0])


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(DTYPES[dtype][1])


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h", [64, 768, 1024])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_ln_forward_matches_pallas_interpret(dtype, h, rows, affine):
    """y, mu and rstd against _ln_fwd_pallas; the odd row counts are not
    a multiple of the TPU kernel's row block, which pads them."""
    x, _, w, b = _inputs(rows, h, affine, seed=h + rows)
    with pallas_config.force("interpret"):
        y_ref, mu_ref, rstd_ref = jax_ln._ln_fwd_pallas(
            _jax(x, dtype), _jax(w, dtype), _jax(b, dtype), EPS)
    y, mu, rstd = port_ln._ln_fwd_plain(_torch(x, dtype), _torch(w, dtype),
                                        _torch(b, dtype), EPS)
    assert y.dtype == DTYPES[dtype][1] and mu.shape == rstd.shape == (rows, 1)
    assert mu.dtype == rstd.dtype == torch.float32
    _close(_np(y), _np(y_ref), dtype, "y")
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h", [64, 768, 1024])
@pytest.mark.parametrize("rows", [7, 33])
@pytest.mark.parametrize("affine", [True, False])
def test_ln_backward_matches_pallas_interpret(dtype, h, rows, affine):
    """dx (and dw, db) against _ln_bwd_pallas on the same x, dy, mu and
    rstd."""
    x, dy, w, b = _inputs(rows, h, affine, seed=2 * h + rows)
    xd = _torch(x, dtype).float().numpy()  # x as the dtype holds it
    mu = xd.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(((xd - mu) ** 2).mean(-1, keepdims=True) + EPS)
    mu, rstd = mu.astype(np.float32), rstd.astype(np.float32)
    with pallas_config.force("interpret"):
        ref = jax_ln._ln_bwd_pallas(_jax(x, dtype), _jax(w, dtype),
                                    jnp.asarray(mu), jnp.asarray(rstd),
                                    _jax(dy, dtype))
    got = port_ln._ln_bwd_plain(_torch(x, dtype), _torch(w, dtype),
                                torch.from_numpy(mu), torch.from_numpy(rstd),
                                _torch(dy, dtype))
    if not affine:
        got, ref = (got,), (ref,)
    assert len(got) == len(ref) == (3 if affine else 1)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        assert a.dtype == DTYPES[dtype][1] and tuple(a.shape) == r.shape
        _close(_np(a), _np(r), dtype, name)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_autograd_matches_jax_vjp(affine):
    """The public layer_norm through _LayerNormAffine / _LayerNormPlain:
    forward and the gradients of x, weight and bias against jax.vjp of
    the JAX package's layer_norm (its custom_vjp) in interpret mode, on
    [2, 5, 64] with leading dims kept."""
    import jax

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    args = (x, w, b) if affine else (x,)

    def jfn(*a):
        return jax_ln.layer_norm(a[0], a[1] if affine else None,
                                 a[2] if affine else None, 64, EPS)

    with pallas_config.force("interpret"):
        y_ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
        grads_ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = port_ln.layer_norm(leaves[0], leaves[1] if affine else None,
                           leaves[2] if affine else None, 64, EPS)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    assert tuple(y.shape) == (2, 5, 64)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=FP32_RTOL, atol=FP32_ATOL)
    for got, ref in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


def test_fused_layer_norm_functional_api():
    """normalization.fused_layer_norm's three LayerNorm functions against
    the JAX package's, with its 1e-6 default eps; the mixed-dtype one
    takes bf16 input and fp32 affine params."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jax_fln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")
    X, W, B = map(torch.from_numpy, (x, w, b))

    got = port_fln.fused_layer_norm_affine(X, W, B, 64)
    ref = jax_fln.fused_layer_norm_affine(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    got = port_fln.fused_layer_norm(X, (64,))
    ref = jax_fln.fused_layer_norm(jnp.asarray(x), (64,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    got = port_fln.mixed_dtype_fused_layer_norm_affine(
        X.to(torch.bfloat16), W, B, 64)
    ref = jax_fln.mixed_dtype_fused_layer_norm_affine(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), 64)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           "bfloat16", "mixed")


def test_ln_cpu_path_never_counts_a_launch():
    before = (port_ln.ln_launches, port_ln.ln_bwd_launches)
    x = torch.randn(7, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    port_ln.layer_norm(x, w, torch.zeros(64, requires_grad=True), 64).sum(
    ).backward()
    assert (port_ln.ln_launches, port_ln.ln_bwd_launches) == before


def test_ln_normalized_shape_mismatch_is_loud():
    with pytest.raises(ValueError, match="normalized_shape"):
        port_ln.layer_norm(torch.zeros(3, 8), None, None, (4,))


def test_rms_functions_match_jax():
    """mixed_dtype_fused_rms_norm_affine (bf16 input, fp32 weight) and
    the unfused manual_rms_norm against the JAX package's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jax_fln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")
    X, W = map(torch.from_numpy, (x, w))
    with pallas_config.force("interpret"):
        ref = jax_fln.mixed_dtype_fused_rms_norm_affine(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 64)
    got = port_fln.mixed_dtype_fused_rms_norm_affine(X.to(torch.bfloat16), W,
                                                     64)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           "bfloat16", "mixed rms")
    for weight in (W, None):
        got = port_fln.manual_rms_norm(X, (64,), weight, EPS)
        ref = jax_fln.manual_rms_norm(
            jnp.asarray(x), (64,),
            None if weight is None else jnp.asarray(w), EPS)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=FP32_RTOL, atol=FP32_ATOL)
    got = port_fln.manual_rms_norm(X.to(torch.bfloat16), 64, None, EPS)
    ref = jax_fln.manual_rms_norm(jnp.asarray(x, jnp.bfloat16), 64, None,
                                  EPS)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           "bfloat16", "manual rms bf16")


MODULES = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("name", MODULES)
def test_module_classes_match_flax(name, affine):
    """Each module class against the JAX package's flax module with the
    same params: forward and the gradients of x and every param, fp32,
    and the mixed classes on bf16 input with fp32 params."""
    import jax

    jax_fln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")
    rng = np.random.default_rng(MODULES.index(name))
    mixed = name.startswith("Mixed")
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jmod = getattr(jax_fln, name)(64, eps=EPS, elementwise_affine=affine)
    mod = getattr(port_fln, name)(64, eps=EPS, elementwise_affine=affine,
                                  device="cpu")
    jx = jnp.asarray(x, jnp.bfloat16 if mixed else jnp.float32)
    with pallas_config.force("interpret"):
        variables = jmod.init(jax.random.PRNGKey(0), jx)
    params = dict(variables.get("params", {}))
    assert sorted(params) == sorted(n for n, _ in mod.named_parameters())
    for pname, p in mod.named_parameters():
        assert p.dtype == torch.float32 and tuple(p.shape) == (64,)
        value = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
        params[pname] = jnp.asarray(value)
        with torch.no_grad():
            p.copy_(torch.from_numpy(value))

    def jfn(p, xx):
        return jmod.apply({"params": p}, xx)

    with pallas_config.force("interpret"):
        y_ref, vjp = jax.vjp(jfn, params, jx)
        dp_ref, dx_ref = vjp(jnp.asarray(g, y_ref.dtype))
    tx = torch.from_numpy(x).to(torch.bfloat16 if mixed
                                else torch.float32).requires_grad_()
    y = mod(tx)
    assert y.dtype == tx.dtype
    leaves = [tx] + [p for _, p in mod.named_parameters()]
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(y.dtype))
    kind = "bfloat16" if mixed else "float32"
    _close(_np(y.detach()), _np(y_ref), kind, "y")
    _close(_np(grads[0]), _np(dx_ref), kind, "dx")
    for (pname, _), got in zip(mod.named_parameters(), grads[1:]):
        # fp32 param grads summed over bf16 terms: the two sums round
        # their bf16 products alike, so one bf16 ulp of the sum bounds them
        _close(_np(got), _np(dp_ref[pname]), kind, pname)
