"""The port's long-row fused softmax and ``FusedScaleMaskSoftmax``
(apex_tpu_torch.transformer.functional.fused_softmax) against the JAX
package's, forward and backward.

The long rows: the port's blocked plain version (the CPU's path for
sk > ``_WHOLE_ROW_MAX_SK``) against the Pallas blocked kernels
(``_stats_kernel`` / ``_apply_kernel``) in interpret mode. As the JAX
package's own tests do, the whole-row limit and the block of keys are
lowered on both sides, so that small inputs take the blocked path.

Tolerances: fp32 outputs to rtol 1e-5 / atol 1e-6 (the online sums are
taken in another order); bf16 outputs to one bf16 ulp of each value,
both sides rounding once from fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import pallas_config
from apex_tpu.transformer import enums as jax_enums
from apex_tpu.transformer.functional import fused_softmax as jax_sm
from apex_tpu_torch.transformer import enums as port_enums
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
from apex_tpu_torch.transformer.functional import fused_softmax as port_sm

RTOL, ATOL = 1e-5, 1e-6
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def short_limit(monkeypatch):
    """Whole rows up to 64 keys, blocks of 32, on both sides."""
    for mod, name in ((jax_sm, "_BLOCKED_BK"), (port_sm, "_BLOCKED_BK")):
        monkeypatch.setattr(mod, name, 32)
    for mod in (jax_sm, port_sm):
        monkeypatch.setattr(mod, "_WHOLE_ROW_MAX_SK", 64)


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _check(got, ref, bf16):
    for a, r in zip(got, ref):
        if bf16:
            assert np.all(np.abs(a - r) <= _bf16_ulp(r) + 1e-6)
        else:
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


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


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return ((4 * rng.standard_normal(shape)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("sq,sk", [(96, 96), (32, 128), (5, 100)])
def test_blocked_causal_matches_pallas(short_limit, dtype, sq, sk):
    """sq < sk checks the sk - sq diagonal offset; sk = 100 leaves a
    ragged last block in the port (the reference takes blocks of 25)."""
    x, g = _data((2, sq, sk), sq + sk)
    jd, td = DT[dtype]
    ref = _vjp_jax(lambda a: jax_sm.scaled_upper_triang_masked_softmax(
        a, None, 0.7), x, g, jd)
    got = _vjp_port(lambda a: port_sm.scaled_upper_triang_masked_softmax(
        a, None, 0.7), x, g, td)
    _check(got, ref, dtype == "bfloat16")


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("mask_shape", [(2, 1, 16, 96), (2, 1, 1, 96),
                                        (16, 96)])
def test_blocked_masked_matches_pallas(short_limit, dtype, mask_shape):
    """Masks broadcast over the heads, over heads and queries, and over
    both lead dims; one query row is fully masked (uniform 1/sk)."""
    x, g = _data((2, 2, 16, 96), 7)
    mask = np.random.default_rng(8).random(mask_shape) < 0.3
    if mask_shape[-2] > 1:
        mask[..., 0, :] = True  # query row 0 fully masked
    jd, td = DT[dtype]
    ref = _vjp_jax(lambda a: jax_sm.scaled_masked_softmax(
        a, jnp.asarray(mask), 0.5), x, g, jd)
    got = _vjp_port(lambda a: port_sm.scaled_masked_softmax(
        a, torch.from_numpy(mask), 0.5), x, g, td)
    _check(got, ref, dtype == "bfloat16")
    if mask_shape[-2] > 1:
        np.testing.assert_allclose(got[0][:, :, 0], 1 / 96, rtol=1e-2)


def test_blocked_rows_minus_inf_in_first_blocks(short_limit):
    """A row whose first blocks are all -inf (an additive -inf mask folded
    into x) must still normalize: the -inf rule keeps exp(-inf - -inf)
    out of the running sums."""
    x, _ = _data((1, 8, 128), 9)
    x[:, :, :64] = -np.inf
    x[:, 3, :96] = -np.inf
    with pallas_config.force("interpret"):
        ref = np.asarray(jax_sm._pallas_blocked(jnp.asarray(x), None, 1.0,
                                                causal=False))
    got = port_sm._blocked_plain(torch.from_numpy(x), None, 1.0,
                                 causal=False).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_blocked_rows_below_the_fill_and_fully_masked(short_limit):
    """Rows whose values all lie below -10000 normalize (the running max
    starts at -inf, not at the fill); a fully masked row is uniform."""
    x = np.full((1, 8, 96), -30000.0, np.float32)
    mask = np.zeros((1, 8, 96), bool)
    mask[0, 2] = True
    with pallas_config.force("interpret"):
        ref = np.asarray(jax_sm._pallas_blocked(
            jnp.asarray(x), jnp.asarray(mask), 1.0, causal=False))
    got = port_sm._blocked_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                 1.0, causal=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, 1 / 96, rtol=1e-6)


def test_stats_pass_matches_the_reference_stats():
    """The stats pass alone: m is the row max of the filled values and l
    the sum of exp(s - m), as the reference's (m, l) outputs."""
    x, _ = _data((3, 40, 5000), 10)
    xt = torch.from_numpy(x)
    m, l = port_sm._stats_plain(xt, None, 0.3, causal=True)
    s = torch.where(port_sm._causal_mask(40, 5000, "cpu"), -10000.0,
                    xt * 0.3)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1),
                               rtol=1e-5, atol=0)


def test_long_rows_dispatch_to_the_blocked_plain_on_the_cpu():
    """Above the real limit, with no monkeypatching: the CPU takes the
    blocked plain version, which agrees with the whole-row one."""
    sk = port_sm._WHOLE_ROW_MAX_SK + 100
    x, _ = _data((1, 3, sk), 11)
    xt = torch.from_numpy(x)
    got = port_sm.scaled_upper_triang_masked_softmax(xt, None, 0.5)
    torch.testing.assert_close(got, port_sm._causal_plain(xt, 0.5),
                               rtol=RTOL, atol=1e-9)
    mask = torch.zeros(1, 1, sk, dtype=torch.bool)
    mask[..., 7::3] = True
    torch.testing.assert_close(port_sm.scaled_masked_softmax(xt, mask, 0.5),
                               port_sm._masked_plain(xt, mask, 0.5),
                               rtol=RTOL, atol=1e-9)


# ------------------------------------------------- FusedScaleMaskSoftmax


def _modules(mask_type, **kw):
    jt = getattr(jax_enums.AttnMaskType, mask_type)
    pt = getattr(port_enums.AttnMaskType, mask_type)
    return (jax_sm.FusedScaleMaskSoftmax(attn_mask_type=jt, **kw),
            FusedScaleMaskSoftmax(attn_mask_type=pt, **kw))


def _mask_func(x, mask):
    return x.masked_fill(mask, -1e4) if isinstance(x, torch.Tensor) \
        else jnp.where(mask, -1e4, x)


ROUTES = {
    "causal": ("causal", None, {}),
    "causal_padding": ("causal", (2, 1, 1, 48), {}),
    "padding": ("padding", (2, 1, 1, 48), {}),
    "padding_no_mask": ("padding", None, {}),
    "mask_func": ("padding", (2, 1, 16, 48), {"mask_func": _mask_func}),
}


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("long_rows", [False, True],
                         ids=["whole_row", "blocked"])
@pytest.mark.parametrize("unfused", [False, True],
                         ids=["fused", "torch_softmax"])
def test_fused_scale_mask_softmax_matches_jax(monkeypatch, dtype, route,
                                              long_rows, unfused):
    """Every route of the module, forward and backward, with scale 0.25;
    ``long_rows`` lowers the whole-row limit on both sides so the 48-key
    rows take the blocked kernels; ``unfused`` runs
    ``forward_torch_softmax`` on both sides."""
    if long_rows:
        for mod in (jax_sm, port_sm):
            monkeypatch.setattr(mod, "_WHOLE_ROW_MAX_SK", 32)
            monkeypatch.setattr(mod, "_BLOCKED_BK", 16)
    mask_type, mask_shape, kw = ROUTES[route]
    jmod, pmod = _modules(mask_type, scale=0.25, **kw)
    x, g = _data((2, 3, 16, 48), 12)
    mask = (None if mask_shape is None
            else np.random.default_rng(13).random(mask_shape) < 0.4)
    jd, td = DT[dtype]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jcall = jmod.forward_torch_softmax if unfused else jmod
    pcall = pmod.forward_torch_softmax if unfused else pmod
    ref = _vjp_jax(lambda a: jcall(a, jmask), x, g, jd)
    got = _vjp_port(lambda a: pcall(a, tmask), x, g, td)
    _check(got, ref, dtype == "bfloat16")


def test_fused_scale_mask_softmax_flags_and_helpers():
    with pytest.raises(ValueError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(ValueError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=0.5)
    mod = FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=False)
    assert mod.input_in_float16 and not list(mod.parameters())
    assert mod.attn_mask_type == port_enums.AttnMaskType.causal
    # the CUDA kernels run one row per block, whatever the shape
    assert FusedScaleMaskSoftmax.get_batch_per_block(16, 4096, 2, 8) == 1
    # no card here: neither side has its fused kernels
    jmod = jax_sm.FusedScaleMaskSoftmax()
    assert mod.is_kernel_available(None, 2, 8, 16, 16) is False
    assert jmod.is_kernel_available(None, 2, 8, 16, 16) is False
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.forward_fused_softmax(torch.zeros(1, 1, 4, 4))


def test_enums_match_jax():
    for name in ("LayerType", "AttnType", "AttnMaskType", "ModelType"):
        jenum, penum = getattr(jax_enums, name), getattr(port_enums, name)
        assert [(m.name, m.value) for m in jenum] == \
            [(m.name, m.value) for m in penum]
