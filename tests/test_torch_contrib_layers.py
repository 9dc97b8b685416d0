"""The port's contrib layers against the JAX package's, the same numpy
inputs and variables on both sides (``tests/contrib/test_contrib.py``'s
``TestLayerNormConv`` and ``test_frozen_batchnorm2d``, held as parity):
``FastLayerNorm`` (the JAX side's Pallas LayerNorm in interpret mode),
the four conv+bias epilogues (NHWC activations, HWIO kernels), the NHWC
BatchNorm at ``bn_group`` 1 (the flax convention's momentum, fused ReLU
and add+ReLU) and ``FrozenBatchNorm2d``.

Tolerances: fp32 throughout, RTOL/ATOL 1e-5 / 1e-5 (sums in another
order; the convolutions' on both sides are the host's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import bottleneck as j_bottleneck
from apex_tpu.contrib import conv_bias_relu as j_conv
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm
from apex_tpu.contrib.layer_norm import fast_layer_norm as j_fast_ln
from apex_tpu.ops import pallas_config
from apex_tpu_torch.contrib import bottleneck, conv_bias_relu, groupbn
from apex_tpu_torch.contrib.layer_norm import FastLayerNorm, fast_layer_norm
from apex_tpu_torch.models import resnet

RTOL, ATOL = 1e-5, 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def test_fast_layer_norm_matches_reference():
    rng = _rng(0)
    x = (rng.standard_normal((6, 64)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((6, 64)).astype(np.float32)
    xs, gs, bs = _t(x, True), _t(g, True), _t(b, True)
    y = fast_layer_norm(xs, gs, bs)
    y.backward(_t(dy))
    with pallas_config.force("interpret"):
        want, vjp = jax.vjp(j_fast_ln, jnp.asarray(x), jnp.asarray(g),
                            jnp.asarray(b))
        dwant = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for got, w in zip((xs.grad, gs.grad, bs.grad), dwant):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    ln = FastLayerNorm(64, device="cpu")
    assert ln.eps == 1e-5 and ln.weight.device.type == "cpu"
    torch.testing.assert_close(
        ln(_t(x)), fast_layer_norm(_t(x), torch.ones(64), torch.zeros(64)),
        rtol=0, atol=0)


CONV_CASES = [("ConvBias", 0, 1), ("ConvBias", 1, 2), ("ConvBiasReLU", 1, 1),
              ("ConvBiasMaskReLU", 1, 1), ("ConvFrozenScaleBiasReLU", 1, 2)]


@pytest.mark.parametrize("name,padding,stride", CONV_CASES)
def test_conv_bias_relu_matches_reference(name, padding, stride):
    rng = _rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, 5))).astype(np.float32)
    b = np.linspace(-1, 1, 5).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(5)).astype(np.float32)
    out = -(-(8 + 2 * padding - 3 + 1) // stride)
    mask = (rng.random((2, out, out, 5)) < 0.6).astype(np.float32)
    dy = rng.standard_normal((2, out, out, 5)).astype(np.float32)
    extra = {"ConvBiasMaskReLU": (mask,),
             "ConvFrozenScaleBiasReLU": (scale,)}.get(name, ())
    if name == "ConvFrozenScaleBiasReLU":
        args, jargs = (x, w, scale, b), (x, w, scale, b)
    else:
        args = jargs = (x, w, b) + extra
    leaves = [_t(a, True) for a in args]
    y = getattr(conv_bias_relu, name)(*leaves, padding=padding,
                                      stride=stride)
    assert tuple(y.shape) == (2, out, out, 5)
    y.backward(_t(dy))
    n_diff = 3 if name != "ConvFrozenScaleBiasReLU" else 4
    f = lambda *a: getattr(j_conv, name)(*a, padding=padding,  # noqa: E731
                                         stride=stride)
    want, vjp = jax.vjp(f, *map(jnp.asarray, jargs))
    dwant = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for got, w_ in zip(leaves[:n_diff], dwant[:n_diff]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w_),
                                   rtol=1e-4, atol=1e-4)


def _bn_variables(c, seed):
    rng = _rng(seed)
    p = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    s = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
         "var": (1 + 0.1 * rng.random(c)).astype(np.float32)}
    return {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}}


@pytest.mark.parametrize("fuse_relu,with_z,train", [
    (True, False, True), (False, True, True), (False, False, True),
    (True, True, False)])
def test_groupbn_matches_reference(fuse_relu, with_z, train):
    rng = _rng(2)
    x = (rng.standard_normal((2, 4, 4, 8)) * 2 + 1).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    dy = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    var = _bn_variables(8, 3)
    bn = groupbn.BatchNorm2d_NHWC(8, fuse_relu=fuse_relu, momentum=0.8)
    pvars = jax.tree_util.tree_map(torch.tensor, var)
    xs = _t(x, True)
    y, stats = bn.apply(pvars, xs, _t(z) if with_z else None, train=train)
    y.backward(_t(dy))

    jbn = JBatchNorm(8, fuse_relu=fuse_relu, momentum=0.8)

    def f(xx):
        out, new = jbn.apply(var, xx, jnp.asarray(z) if with_z else None,
                             train=train, mutable=["batch_stats"])
        return out, new

    _, new = f(jnp.asarray(x))
    want, vjp = jax.vjp(lambda xx: f(xx)[0], jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xs.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-4, atol=1e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            stats["BatchNorm_0"][k].numpy(),
            np.asarray(new["batch_stats"]["BatchNorm_0"][k]), rtol=RTOL,
            atol=1e-6)
    if fuse_relu or with_z:
        assert float(y.detach().min()) >= 0.0


def test_groupbn_init_is_the_reference_layout():
    v = groupbn.BatchNorm2d_NHWC(8).init(device="cpu")
    jv = JBatchNorm(8).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 8)))
    got = {c: {k: {n: t.numpy() for n, t in d.items()}
               for k, d in v[c].items()} for c in v}
    want = jax.tree_util.tree_map(np.asarray, dict(jv))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    sync = groupbn.BatchNorm2d_NHWC(8, bn_group=2).init(device="cpu")
    assert set(sync["params"]) == {"SyncBatchNorm_0"}


def test_frozen_batchnorm2d_matches_reference():
    rng = _rng(4)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    frozen = {"weight": np.full(3, 2.0, np.float32),
              "bias": np.ones(3, np.float32),
              "running_mean": np.full(3, 0.5, np.float32),
              "running_var": np.full(3, 4.0, np.float32)}
    jbn = j_bottleneck.FrozenBatchNorm2d(3)
    bn = bottleneck.FrozenBatchNorm2d(3)
    pv = {"frozen": {k: torch.tensor(v) for k, v in frozen.items()}}
    jv = {"frozen": {k: jnp.asarray(v) for k, v in frozen.items()}}
    np.testing.assert_allclose(bn.apply(pv, _t(x)).numpy(),
                               np.asarray(jbn.apply(jv, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    xc = np.moveaxis(x, -1, 1)
    np.testing.assert_allclose(
        bn.apply(pv, _t(xc), nhwc=False).numpy(),
        np.asarray(jbn.apply(jv, jnp.asarray(xc), nhwc=False)), rtol=1e-6,
        atol=1e-6)
    scale, bias = bn.get_scale_bias(pv)
    jscale, jbias = jbn.apply(jv, method="get_scale_bias", nhwc=True)
    assert tuple(scale.shape) == (1, 1, 1, 3)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=1e-6)
    # default buffers: the identity up to eps
    ident = bn.apply(bn.init(device="cpu"), _t(x))
    np.testing.assert_allclose(ident.numpy(), x, rtol=1e-4, atol=1e-4)
    assert bottleneck.Bottleneck is resnet.Bottleneck
