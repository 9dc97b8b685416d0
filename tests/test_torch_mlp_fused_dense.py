"""The port's fused MLP and fused dense layers (``apex_tpu_torch.mlp``,
``apex_tpu_torch.fused_dense``) against the JAX package's on the CPU,
from the same numpy inputs and params (made from seeds).

Tolerances:

- fp32: outputs and gradients elementwise within RTOL = 1e-5 and an
  absolute floor of 1e-5 times the array's largest value: both sides
  sum the same fp32 products in another order.
- bf16: both sides sum in fp32 and round each layer's output to bf16,
  so a sum that lands within an fp32 rounding of a bf16 tie rounds the
  other way (one bf16 ulp, 2^-8 relative) and moves what follows:
  relative L2 within BF16_REL = 1e-2 of each array.
- O4 (the fp8 products under delayed scales): the casts are bit for bit
  (test_torch_fp8_cast.py) and the products sum the same fp8 values in
  fp32 in another order; a chained layer quantizes that sum again, so a
  sum within an fp32 rounding of an fp8 tie casts one fp8 ulp away.
  Losses, outputs and gradients within FP8_REL = 1e-3 in relative L2,
  the forward amaxes exactly (the max of the same inputs, the first
  layer's; later layers' within FP8_REL), the E5M2 amaxes within
  FP8_REL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fused_dense as jfd
from apex_tpu import mlp as jmlp
from apex_tpu.amp.scaler import Fp8DelayedScaler as JaxFp8
from apex_tpu_torch import fused_dense as fd
from apex_tpu_torch import mlp
from apex_tpu_torch.amp import amp as port_amp
from apex_tpu_torch.amp.scaler import Fp8DelayedScaler
from apex_tpu_torch.ops import fp8_cast_kernel

RTOL = 1e-5
BF16_REL = 1e-2
FP8_REL = 1e-3
SIZES = (24, 32, 48, 16, 1)  # the last layer one unit, as Apex's run_mlp
BATCH = 12


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16_exact(a):
    """``a`` rounded to bf16 values, kept as fp32 numpy."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _j(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == torch.bfloat16:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= BF16_REL, f"{what}: rel L2 {rel}"
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()),
                                   err_msg=what)


def _rel_close(got, want, tol, what):
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= tol, f"{what}: rel L2 {rel}"


def _mlp_params(bias, seed=0, sizes=SIZES):
    out = []
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        out.append(_rand((fi, fo), seed + 2 * i, fi ** -0.5))
        if bias:
            out.append(_rand((fo,), seed + 2 * i + 1, 0.1))
    return out


def _value_and_grads(port_fn, jax_fn, arrays, dtype, cot_seed):
    """Each side's output and the gradients of ``sum(y * r)`` w.r.t.
    every input, ``r`` a fixed random cotangent."""
    if dtype == torch.bfloat16:
        arrays = [_bf16_exact(a) for a in arrays]
    jin = [_j(a, dtype) for a in arrays]
    jy = jax_fn(*jin)
    r = _rand(jy.shape, cot_seed)

    def jloss(*xs):
        return jnp.sum(jax_fn(*xs).astype(jnp.float32) * r)

    jg = jax.grad(jloss, argnums=tuple(range(len(jin))))(*jin)
    pin = [_t(a, dtype).requires_grad_() for a in arrays]
    py = port_fn(*pin)
    pg = torch.autograd.grad((py.float() * torch.from_numpy(r)).sum(), pin)
    return (py, jy), list(zip(pg, jg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
def test_mlp_function_matches_jax(activation, bias, dtype):
    x = _rand((BATCH, SIZES[0]), 100)
    arrays = [x] + _mlp_params(bias)
    (py, jy), grads = _value_and_grads(
        lambda *a: mlp.mlp_function(bias, activation, *a),
        lambda *a: jmlp.mlp_function(bias, activation, *a), arrays, dtype,
        7)
    assert py.dtype == dtype
    _close(py, jy, dtype, "output")
    for i, (g, jg) in enumerate(grads):
        assert g.dtype == dtype
        _close(g, jg, dtype, f"grad {i}")


def test_mlp_backward_recomputes_and_saves_inputs_only():
    """The custom backward keeps only x and the params: no hidden
    activation is saved, and its grads equal plain autograd's."""
    x = torch.from_numpy(_rand((BATCH, SIZES[0]), 3)).requires_grad_()
    wb = [torch.from_numpy(a).requires_grad_() for a in _mlp_params(True)]
    y = mlp.mlp_function(True, "relu", x, *wb)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 + len(wb)
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved,
                                                            [x] + wb))
    g = torch.autograd.grad(y.sum(), [x] + wb)
    want = torch.autograd.grad(mlp._forward(True, "relu", x, wb).sum(),
                               [x] + wb)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_mlp_module_matches_function_and_validates():
    with pytest.raises(TypeError, match="activation"):
        mlp.MLP([4, 4], activation="tanh", device="cpu")
    m = mlp.MLP([8, 16, 4], activation="sigmoid", seed=3, device="cpu")
    assert [tuple(p["w"].shape) for p in m.params] == [(8, 16), (16, 4)]
    assert all(float(p["w"].abs().max()) <= 8 ** -0.5 for p in m.params[:1])
    x = torch.from_numpy(_rand((5, 8), 1))
    assert torch.equal(m(x), mlp.mlp_function(True, "sigmoid", x,
                                              *m.flat()))
    again = mlp.MLP([8, 16, 4], activation="sigmoid", seed=3, device="cpu")
    assert torch.equal(again.params[1]["b"], m.params[1]["b"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["fused_dense", "dense_no_bias",
                                "fused_dense_gelu_dense"])
def test_fused_dense_functions_match_jax(fn, dtype):
    x = _rand((3, 5, 24), 10)
    shapes = {"fused_dense": [(24, 40), (40,)],
              "dense_no_bias": [(24, 40)],
              "fused_dense_gelu_dense": [(24, 64), (64,), (64, 16), (16,)]}
    arrays = [x] + [_rand(s, 20 + i, 0.2) for i, s in
                    enumerate(shapes[fn])]
    (py, jy), grads = _value_and_grads(
        getattr(fd, f"{fn}_function"), getattr(jfd, f"{fn}_function"),
        arrays, dtype, 11)
    assert py.dtype == dtype
    _close(py, jy, dtype, "output")
    for i, (g, jg) in enumerate(grads):
        _close(g, jg, dtype, f"grad {i}")


def test_fused_dense_gelu_dense_saves_gelu_in_and_output1():
    x = torch.from_numpy(_rand((4, 8), 1)).requires_grad_()
    p = fd.FusedDenseGeluDense(8, 16, 4, device="cpu").params
    y = fd.fused_dense_gelu_dense_function(
        x, p["weight1"], p["bias1"], p["weight2"], p["bias2"])
    saved = y.grad_fn.saved_tensors
    gelu_in = x @ p["weight1"] + p["bias1"]
    assert len(saved) == 5
    torch.testing.assert_close(saved[3], gelu_in)
    torch.testing.assert_close(saved[4], torch.nn.functional.gelu(gelu_in))
    with pytest.raises(ValueError, match="bias=True"):
        fd.FusedDenseGeluDense(8, 16, 4, bias=False, device="cpu")
    dense = fd.FusedDense(8, 4, bias=False, device="cpu")
    assert set(dense.params) == {"weight"}
    torch.testing.assert_close(dense(x), x @ dense.params["weight"])


def _o1_call(name):
    x = torch.ones(2, 3)
    w, b = torch.ones(3, 3), torch.zeros(3)
    return {"mlp": lambda: mlp.mlp_function(True, "relu", x, w, b, w, b),
            "fused_dense": lambda: fd.fused_dense_function(x, w, b),
            "dense_no_bias": lambda: fd.dense_no_bias_function(x, w),
            "fused_dense_gelu_dense":
                lambda: fd.fused_dense_gelu_dense_function(x, w, b, w, b)
            }[name]


@pytest.mark.parametrize("name", ["mlp", "fused_dense", "dense_no_bias",
                                  "fused_dense_gelu_dense"])
def test_half_functions_cast_under_o1(name):
    """Registered as amp half functions, as the reference's are: under an
    O1 policy fp32 inputs reach the function in the compute dtype, and
    with no policy they pass as they are."""
    from apex_tpu_torch.amp.frontend import Policy

    module = mlp if name == "mlp" else fd
    fn = getattr(module, f"{name}_function")
    assert fn.__wrapped_amp_category__ == "compute"
    assert _o1_call(name)().dtype == torch.float32
    with port_amp.casting(Policy(torch.float32, torch.bfloat16,
                                 torch.float32)):
        assert _o1_call(name)().dtype == torch.bfloat16


# ------------------------------------------------------------------ O4


def _fp8_case(name):
    if name == "mlp":
        n = len(SIZES) - 1
        arrays = [_rand((BATCH, SIZES[0]), 30, 2.0)] + _mlp_params(True, 40)
        return (["mlp"] * n, lambda *a: mlp.mlp_function(True, "relu", *a),
                lambda *a: jmlp.mlp_function(True, "relu", *a), arrays)
    arrays = [_rand((2, 6, 32), 31, 2.0), _rand((32, 48), 41, 0.2),
              _rand((48,), 42, 0.1), _rand((48, 16), 43, 0.2),
              _rand((16,), 44, 0.1)]
    return (["fused_dense"] * 2, fd.fused_dense_gelu_dense_function,
            jfd.fused_dense_gelu_dense_function, arrays)


@pytest.mark.parametrize("case", ["mlp", "fused_dense_gelu_dense"])
def test_o4_fp8_sites_match_jax(case):
    """Two steps under each package's Fp8DelayedScaler at the modules'
    sites (every product registered): losses, gradients and the rings
    after each update, the custom backward stepping aside on both sides.
    The second step runs under the scales the first step's amaxes set."""
    sites, port_fn, jax_fn, arrays = _fp8_case(case)
    r = None
    jf, pf = JaxFp8(sites, history=4), Fp8DelayedScaler(sites, history=4)
    js, ps = jf.init(), pf.init(device="cpu")
    casts0 = (fp8_cast_kernel.launches, fp8_cast_kernel.col_launches)
    for step in range(2):
        jin = [jnp.asarray(a) for a in arrays]
        pin = [torch.from_numpy(a) for a in arrays]
        if r is None:
            r = _rand(np.shape(jax_fn(*jin)), 9)

        def jloss(*xs):
            return jnp.sum(jax_fn(*xs) * r)

        def ploss(*xs):
            return (port_fn(*xs) * torch.from_numpy(r)).sum()

        argnums = tuple(range(len(arrays)))
        with jf.step(js) as jctx:
            jl, jg = jctx.value_and_grad(jloss, argnums=argnums)(*jin)
        with pf.step(ps) as pctx:
            pl, pg = pctx.value_and_grad(ploss, argnums=argnums)(*pin)
        assert not pctx.skipped_sites
        _rel_close(pl, jl, FP8_REL, f"step {step} loss")
        for i, (g, want) in enumerate(zip(pg, jg)):
            _rel_close(g, want, FP8_REL, f"step {step} grad {i}")
        np.testing.assert_array_equal(_np(pctx.fwd_amax())[:2],
                                      _np(jctx.fwd_amax())[:2])
        _rel_close(pctx.fwd_amax(), jctx.fwd_amax(), FP8_REL, "fwd amax")
        _rel_close(pctx.grad_amax(), jctx.grad_amax(), FP8_REL,
                   "grad amax")
        js, ps = jf.update(js, jctx), pf.update(ps, pctx)
        assert float(ps.grad.ring[:, step].min()) > 0  # every site observed
    _rel_close(ps.fwd.ring, js.fwd.ring, FP8_REL, "fwd ring")
    _rel_close(ps.grad.ring, js.grad.ring, FP8_REL, "grad ring")
    # the CPU runs the plain casts: the kernel counters never move here
    assert (fp8_cast_kernel.launches,
            fp8_cast_kernel.col_launches) == casts0
