"""Parity of the port's multi-tensor ops
(apex_tpu_torch.multi_tensor_apply) with the JAX package's: scale,
axpby, the L2 norms (global and per tensor, ``_mp``), ``l2norm_scale``,
each op's overflow flag on inf and on NaN, and ``multi_tensor_applier``'s
``[inputs..., outputs...]`` convention. Outputs in fp32 agree within
1e-6 relative (summation order), the bf16 outputs bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import multi_tensor_applier as jax_applier
from apex_tpu.multi_tensor_apply import multi_tensor_axpby as jax_axpby
from apex_tpu.multi_tensor_apply import multi_tensor_l2norm as jax_l2norm
from apex_tpu.multi_tensor_apply import (
    multi_tensor_l2norm_mp as jax_l2norm_mp,
)
from apex_tpu.multi_tensor_apply import (
    multi_tensor_l2norm_scale as jax_l2norm_scale,
)
from apex_tpu.multi_tensor_apply import multi_tensor_scale as jax_scale
from apex_tpu_torch.multi_tensor_apply import (
    MultiTensorApply,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_l2norm_mp,
    multi_tensor_l2norm_scale,
    multi_tensor_scale,
)

RTOL = 1e-6
SHAPES = [(5, 7), (13,), (2, 3, 4), (1,)]


def _lists(seed, dtype=np.float32, poison=None):
    rng = np.random.default_rng(seed)
    arrs = [(3.0 * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]
    if poison is not None:
        arrs[2].reshape(-1)[5] = poison
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrs])


def _same(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("out", [None, "fp32"], ids=["own", "to_fp32"])
def test_scale_matches_jax(dtype, out):
    jx, x = _lists(0, dtype)
    jout, jflag = jax_scale(jx, 0.37, out_dtype=out and jnp.float32)
    got, flag = multi_tensor_scale(x, 0.37, out_dtype=out and torch.float32)
    _same(got, jout, exact=True)
    assert got[0].dtype == (torch.float32 if out or dtype != "bf16"
                            else torch.bfloat16)
    assert bool(flag) is bool(jflag) is False


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["fp32", "bf16"])
def test_axpby_matches_jax(dtype):
    jx, x = _lists(1, dtype)
    jy, y = _lists(2, dtype)
    jout, jflag = jax_axpby(jx, jy, 0.5, -1.25)
    got, flag = multi_tensor_axpby(x, y, 0.5, -1.25)
    _same(got, jout, exact=dtype == "bf16")
    assert bool(flag) is bool(jflag) is False


@pytest.mark.parametrize("fn,jfn", [(multi_tensor_l2norm, jax_l2norm),
                                    (multi_tensor_l2norm_mp, jax_l2norm_mp)],
                         ids=["l2norm", "l2norm_mp"])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["fp32", "bf16"])
def test_l2norms_match_jax(fn, jfn, dtype):
    jx, x = _lists(3, dtype)
    jtotal, jper = jfn(jx, per_tensor=True)
    total, per = fn(x, per_tensor=True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=RTOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=RTOL)
    assert total.dtype == per.dtype == torch.float32
    assert fn(x)[1] is None


def test_l2norm_scale_matches_jax():
    jx, x = _lists(4)
    jout, jnorm, jper, jflag = jax_l2norm_scale(jx, 0.5, per_tensor=True)
    out, norm, per, flag = multi_tensor_l2norm_scale(x, 0.5, per_tensor=True)
    _same(out, jout, exact=True)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=RTOL)
    assert bool(flag) is bool(jflag) is False
    assert multi_tensor_l2norm_scale(x, 0.5)[2] is None


@pytest.mark.parametrize("poison", [np.inf, -np.inf, np.nan],
                         ids=["inf", "-inf", "nan"])
@pytest.mark.parametrize("op", ["scale", "axpby", "l2norm_scale"])
def test_overflow_flag_on_a_non_finite_value(poison, op):
    jx, x = _lists(5, poison=poison)
    jy, y = _lists(6)
    if op == "scale":
        jflag, flag = jax_scale(jx, 2.0)[1], multi_tensor_scale(x, 2.0)[1]
    elif op == "axpby":
        jflag = jax_axpby(jy, jx, 1.0, 1.0)[1]
        flag = multi_tensor_axpby(y, x, 1.0, 1.0)[1]
    else:
        jflag = jax_l2norm_scale(jx, 2.0)[3]
        flag = multi_tensor_l2norm_scale(x, 2.0)[3]
    assert flag.dtype == torch.bool and flag.shape == ()
    assert bool(flag) is bool(jflag) is True


def test_overflow_from_the_product():
    """A finite input whose product overflows fp32 flags, as in the
    reference (the check is on the fp32 result)."""
    x = [torch.full((3,), 3e38)]
    assert bool(multi_tensor_scale(x, 2.0)[1])
    assert bool(jax_scale([jnp.full((3,), 3e38)], 2.0)[1])


def test_applier_convention_matches_jax():
    """``applier(op, overflow_buf, [inputs..., outputs...], *args)``:
    the leading ``n_input_lists`` lists are inputs, the trailing outputs
    are ignored, results returned."""
    jx, x = _lists(7)
    jy, y = _lists(8)
    buf = torch.zeros(1, dtype=torch.int32)
    jout, _ = jax_applier(jax_scale, None, [jx, jx], 0.25)
    out, flag = multi_tensor_applier(multi_tensor_scale, buf, [x, x], 0.25)
    _same(out, jout, exact=True)
    assert all(a is not b for a, b in zip(out, x))
    jout, _ = jax_applier(jax_axpby, None, [jx, jy, jx], 2.0, 3.0)
    out, _ = multi_tensor_applier(multi_tensor_axpby, buf, [x, y, x],
                                  2.0, 3.0)
    _same(out, jout)
    jtotal, _ = jax_applier(jax_l2norm, None, [jx])
    total, per = multi_tensor_applier(multi_tensor_l2norm, buf, [x], True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=RTOL)
    assert per.shape == (len(SHAPES),)
    assert int(buf.sum()) == 0  # the flag is returned, never written
    assert MultiTensorApply.check_avail() is None
    assert MultiTensorApply(1024).chunk_size == 1024
    for op in (multi_tensor_scale, multi_tensor_axpby, multi_tensor_l2norm,
               multi_tensor_l2norm_mp, multi_tensor_l2norm_scale):
        assert op.n_input_lists == getattr(
            __import__("apex_tpu.multi_tensor_apply", fromlist=[
                op.__name__]), op.__name__).n_input_lists


def test_a_mixed_dtype_list_is_refused():
    x = [torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="uniform dtype"):
        multi_tensor_scale(x, 1.0)
    with pytest.raises(ValueError, match="uniform dtype"):
        multi_tensor_axpby(x, x)
    total, per = multi_tensor_l2norm([], per_tensor=True)
    assert float(total) == 0.0 and per.shape == (0,)
