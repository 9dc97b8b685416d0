"""SyncBatchNorm of the port (``apex_tpu_torch.parallel.sync_batchnorm``)
on 4 gloo ranks on the CPU, against the JAX package's flax
``SyncBatchNorm`` under ``shard_map`` over 4 simulated devices
(``tests/distributed/test_sync_batchnorm.py``), from the same numpy
batches.

Tolerance: the statistics are fp32 sums merged across ranks, by gloo
here and by XLA there, in other orders: outputs, running stats and
gradients agree to 1e-5 (relative, with an absolute floor of 1e-5 for
values near 0). The large-mean case is also held against float64 numpy
at the reference test's 5e-2.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import SyncBatchNorm as JSyncBN
from apex_tpu_torch.parallel import (
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
)
from torch_dist_worker import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(5)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"g_x": f32(16, 6), "rs_x": f32(16, 4) * 3.0 + 1.5,
            "wf_x": (1e4 + 1e-1 * f32(64, 4)).astype(np.float32),
            "gs_x": (f32(16, 6) * 3 + np.arange(16, dtype=np.float32)[
                :, None]).astype(np.float32),
            "bw_x": f32(16, 6), "bw_dy": f32(16, 6), "bw_w": f32(6),
            "bw_b": f32(6)}


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("syncbn", 4, tmp_path_factory.mktemp("bn"),
                             inputs)


def _mesh():
    return Mesh(np.array(jax.devices()[:4]), ("data",))


def _jax_apply(bn, x, variables=None, extra_out=False):
    x = jnp.asarray(x)
    if variables is None:
        variables = bn.init(jax.random.PRNGKey(1), x[:2])

    def f(x):
        y, upd = bn.apply(variables, x, mutable=["batch_stats"])
        if not extra_out:
            return y
        return y, upd["batch_stats"]["mean"], upd["batch_stats"]["var"]

    out = jax.jit(shard_map(
        f, mesh=_mesh(), in_specs=P("data"),
        out_specs=(P("data"), P(), P()) if extra_out else P("data")))(x)
    return tuple(map(np.asarray, out)) if extra_out else np.asarray(out)


def _gathered(ranks, key):
    return np.concatenate([res[key] for res in ranks])


def test_syncbn_matches_global_batch_stats(bn_ranks):
    inputs, ranks = bn_ranks
    want = _jax_apply(JSyncBN(), inputs["g_x"])
    np.testing.assert_allclose(_gathered(ranks, "global"), want, **TOL)


def test_syncbn_running_stats_accumulate_globally(bn_ranks):
    inputs, ranks = bn_ranks
    _, mean, var = _jax_apply(JSyncBN(momentum=1.0), inputs["rs_x"],
                              extra_out=True)
    for res in ranks:
        np.testing.assert_allclose(res["rs_mean"], mean, **TOL)
        np.testing.assert_allclose(res["rs_var"], var, **TOL)
        np.testing.assert_allclose(res["rs_var"],
                                   inputs["rs_x"].var(0, ddof=1), rtol=1e-3)


def test_welford_survives_large_mean(bn_ranks):
    """mean 1e4, std 1e-1: a sum of squares cancels in fp32; Chan's merge
    of (count, mean, M2) recovers the variance (ref ``csrc/welford.cu``).
    At 1e4 an fp32 value, and so each side's mean, is exact to about
    1e-3, 1% of the std: the normalised outputs of the two packages, as
    each against float64, agree to the reference test's 5e-2."""
    inputs, ranks = bn_ranks
    x = inputs["wf_x"]
    got = _gathered(ranks, "welford")
    want = _jax_apply(JSyncBN(affine=False), x)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(
        got, (x64 - x64.mean(0)) / np.sqrt(x64.var(0) + 1e-5), rtol=5e-2,
        atol=5e-2)


def test_syncbn_group_size_subgroups(bn_ranks):
    """group_size 2 on 4 ranks: consecutive pairs share statistics
    (ref ``test_groups.py``), through create_syncbn_process_group."""
    inputs, ranks = bn_ranks
    want = _jax_apply(JSyncBN(affine=False, process_group=("data", 2)),
                      inputs["gs_x"])
    got = _gathered(ranks, "grouped")
    np.testing.assert_allclose(got, want, **TOL)
    whole = _jax_apply(JSyncBN(affine=False), inputs["gs_x"])
    assert not np.allclose(got, whole, atol=1e-2)
    for res in ranks:
        assert str(res["group"]) == "('data', 2)"
        assert str(res["whole"]) == "None"
        assert "group_size=3 must divide" in str(res["group3"])


def _jax_grads(bn, inputs, x_key, affine=True):
    x = jnp.asarray(inputs[x_key])
    dy = jnp.asarray(inputs["bw_dy"])
    variables = bn.init(jax.random.PRNGKey(1), x[:2])
    if affine:
        variables = {"params": {"scale": jnp.asarray(inputs["bw_w"]),
                                "bias": jnp.asarray(inputs["bw_b"])},
                     "batch_stats": variables["batch_stats"]}

    def f(x, dy, params):
        def loss(x, params):
            v = dict(variables, params=params) if affine else variables
            y, _ = bn.apply(v, x, mutable=["batch_stats"])
            return jnp.sum(y * dy)

        dx, dp = jax.grad(loss, argnums=(0, 1))(x, params)
        return dx, dp

    params = variables.get("params", {})
    return jax.jit(shard_map(f, mesh=_mesh(),
                             in_specs=(P("data"), P("data"), P()),
                             out_specs=(P("data"), P())))(x, dy, params)


def test_syncbn_backward_through_the_statistics(bn_ranks):
    """dx, and the weight and bias grads summed over the ranks (each
    rank's are its own batch's), against the reference's grads through
    its psums (and through the group's all-gather)."""
    inputs, ranks = bn_ranks
    dx, dp = _jax_grads(JSyncBN(), inputs, "bw_x")
    np.testing.assert_allclose(_gathered(ranks, "bw_dx"), np.asarray(dx),
                               **TOL)
    np.testing.assert_allclose(sum(res["bw_dw"] for res in ranks),
                               np.asarray(dp["scale"]), **TOL)
    np.testing.assert_allclose(sum(res["bw_db"] for res in ranks),
                               np.asarray(dp["bias"]), **TOL)
    gdx, _ = _jax_grads(JSyncBN(affine=False, process_group=("data", 2)),
                        inputs, "gs_x", affine=False)
    np.testing.assert_allclose(_gathered(ranks, "grouped_dx"),
                               np.asarray(gdx), **TOL)


def test_syncbn_single_process_and_nchw():
    """Outside a process group the statistics are the local batch's, as
    the reference's outside shard_map; NCHW takes dim 1."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    bn = JSyncBN()
    want, _ = bn.apply(bn.init(jax.random.PRNGKey(1), x), x,
                       mutable=["batch_stats"])
    got = SyncBatchNorm(5, device="cpu")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    x4 = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    bn4 = JSyncBN(channel_last=False)
    want4, _ = bn4.apply(bn4.init(jax.random.PRNGKey(1), x4), x4,
                         mutable=["batch_stats"])
    got4 = SyncBatchNorm(3, device="cpu")(
        torch.from_numpy(x4)).detach().numpy()
    np.testing.assert_allclose(got4, np.asarray(want4), **TOL)
    last = SyncBatchNorm(3, device="cpu", channel_last=True)(
        torch.from_numpy(x4.transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(last.detach().numpy(),
                               got4.transpose(0, 2, 3, 1), **TOL)


def test_syncbn_eval_uses_running_stats():
    bn = SyncBatchNorm(3, device="cpu").eval()
    y = bn(torch.ones(4, 3) * 5.0)
    np.testing.assert_allclose(y.detach().numpy(), 5.0 * np.ones((4, 3)),
                               rtol=1e-5)
    x = np.ones((4, 3), np.float32)
    jbn = JSyncBN()
    jy = jbn.apply(jbn.init(jax.random.PRNGKey(0), x), x * 5.0,
                   use_running_average=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5)


def test_convert_syncbn_model_replaces_every_batchnorm():
    """Every torch BatchNorm in the tree, in containers and nested,
    becomes a SyncBatchNorm with its settings, params and running stats
    (ref ``convert_syncbn_model``); a tree with none passes through."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8, eps=1e-3,
                                                        momentum=0.05),
        torch.nn.ModuleDict({"inner": torch.nn.Sequential(
            torch.nn.BatchNorm2d(8, affine=False))}),
        torch.nn.ModuleList([torch.nn.BatchNorm2d(8)]))
    with torch.no_grad():
        net[1].weight.uniform_()
        net[1].running_mean.fill_(0.25)
    x = torch.randn(2, 3, 6, 6)
    with torch.no_grad():
        want = copy.deepcopy(net[1])(net[0](x))
    out = convert_syncbn_model(net, process_group="data")
    assert out is net
    first = net[1]
    assert isinstance(first, SyncBatchNorm)
    assert first.eps == 1e-3 and first.momentum == 0.05
    assert first.group == "data"
    assert isinstance(net[2]["inner"][0], SyncBatchNorm)
    assert net[2]["inner"][0].weight is None
    assert isinstance(net[3][0], SyncBatchNorm)
    assert float(first.running_mean[0]) == 0.25
    net.train()
    got = first(net[0](x))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    single = convert_syncbn_model(torch.nn.BatchNorm1d(4))
    assert isinstance(single, SyncBatchNorm)
    dense = torch.nn.Linear(3, 3)
    assert convert_syncbn_model(dense) is dense


def test_create_syncbn_process_group_validates():
    assert create_syncbn_process_group(0, world_size=8) is None
    assert create_syncbn_process_group(8, world_size=8) is None
    assert create_syncbn_process_group(2, world_size=8) == ("data", 2)
    with pytest.raises(ValueError, match="must be positive and divide"):
        create_syncbn_process_group(3, world_size=8)
