"""The port's ResNet (``apex_tpu_torch.models.resnet``) and its BatchNorm
switch against the JAX package's flax ResNet on the CPU, from the same
variables (the port's seeded init carried to flax by permuting the conv
kernels OIHW -> HWIO) and the same numpy batch.

Tolerance: 1e-5 relative. Logits and batch stats are held elementwise
(rtol 1e-5, with an absolute floor of 1e-5 times the tensor's largest
value); gradients elementwise with rtol 1e-5 and a floor of 1e-5 times
the largest gradient of the whole tree, since a BatchNorm bias's gradient
is a sum over the batch that cancels (the stem's, summed over two ranks
in another order, reads 1.3e-5 of its own norm); parameters after 3
steps by their displacement's relative L2 error. Both sides compute in
fp32 and differ by the order of their sums: against a float64 run of the
reference the port's gradients are within 8e-6 of each leaf's largest
value, the reference's own within 1.6e-5 (its gradient through
``E[x^2] - E[x]^2``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import resnet as jresnet
from apex_tpu.optimizers import fused_sgd as jfused_sgd
from apex_tpu_torch import _tree, amp
from apex_tpu_torch.models import resnet
from apex_tpu_torch.optimizers import fused_sgd
from torch_dist_worker import run_ranks

TOL = 1e-5
# a leaf's displacement after 3 steps of each side's own trajectory: the
# reference's fp32 gradient of a BatchNorm scale is itself off a float64
# run by up to 1.6e-5 at one step, and the port's up to 0.8e-5; the
# worst leaf measured 1.7e-5 (Bottleneck_0/BatchNorm_0's scale)
STEPS_LEAF_TOL = 5e-5


def _batch(n=4, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    return x, rng.integers(0, classes, n).astype(np.int32)


def _to_flax(tree):
    """The port's variables as numpy in flax's layout (HWIO kernels)."""
    if isinstance(tree, dict):
        return {k: _to_flax(v) for k, v in tree.items()}
    a = tree.detach().numpy()
    return np.array(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)


def _variables(model, seed=0, stats_seed=None):
    v = resnet.init_variables(torch.Generator().manual_seed(seed), model,
                              device="cpu")
    if stats_seed is not None:  # running stats away from (0, 1)
        rng = np.random.default_rng(stats_seed)
        for leaf in _tree.leaves(v["batch_stats"]):
            leaf.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)))
    return v


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def _grads_close(pairs):
    """Each ``(path, got, want)`` leaf elementwise within rtol 1e-5 and
    1e-5 of the largest gradient of the tree."""
    pairs = list(pairs)
    scale = max(float(np.abs(w).max()) for _, _, w in pairs)
    for path, got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                                   err_msg=str(path))
    return len(pairs)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pairs(port_tree, flax_tree, prefix=()):
    """``(path, port numpy in flax layout, flax numpy)`` of every leaf."""
    for k in sorted(port_tree):
        if isinstance(port_tree[k], dict):
            yield from _pairs(port_tree[k], flax_tree[k], prefix + (k,))
        else:
            yield prefix + (k,), _to_flax(port_tree[k]), np.asarray(
                flax_tree[k])


def _jax_train(model, flax_vars, x):
    logits, mut = model.apply(flax_vars, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    return np.asarray(logits), mut["batch_stats"]


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_reference(train):
    model = resnet.tiny()
    v = _variables(model, stats_seed=1)
    x, _ = _batch()
    got, _ = model.apply(v, torch.from_numpy(x), train=train)
    jm = jresnet.tiny()
    if train:
        want, _ = _jax_train(jm, _to_flax(v), x)
    else:
        want = jm.apply(_to_flax(v), jnp.asarray(x), train=False)
    _close(got.detach(), want)


def test_batch_stats_biased_variance_and_momentum():
    """flax's BatchNorm: momentum 0.9 kept, the batch's BIASED variance;
    the new stats equal the reference's and, for the stem, the ones
    computed here from the stem's output (2 images of 8 x 8: 32 values a
    channel, so the unbiased variance is 3% larger)."""
    model = resnet.tiny()
    v = _variables(model, stats_seed=2)
    x, _ = _batch(n=2, size=8)
    _, stats = model.apply(v, torch.from_numpy(x), train=True)
    _, want = _jax_train(jresnet.tiny(), _to_flax(v), x)
    for _, got, ref in _pairs(stats, want):
        _close(got, ref)
    stem = resnet.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       v["params"]["Conv_0"]["kernel"], (2, 2))
    old = v["batch_stats"]["BatchNorm_0"]["BatchNorm_0"]
    new = stats["BatchNorm_0"]["BatchNorm_0"]
    biased = stem.var(dim=(0, 2, 3), unbiased=False)
    _close(new["var"], 0.9 * old["var"] + 0.1 * biased)
    _close(new["mean"], 0.9 * old["mean"] + 0.1 * stem.mean((0, 2, 3)))
    unbiased = 0.9 * old["var"] + 0.1 * stem.var(dim=(0, 2, 3))
    assert not np.allclose(new["var"].numpy(), unbiased.numpy(), rtol=1e-3,
                           atol=0)


def _port_grads(model, v, x, y):
    live = _tree.map_leaves(lambda p: p.clone().requires_grad_(),
                            v["params"])
    logits, stats = model.apply({"params": live,
                                 "batch_stats": v["batch_stats"]},
                                torch.from_numpy(x), train=True)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, _tree.leaves(live))
    return float(loss), _tree.unflatten(_tree.paths(live), list(grads)), \
        stats


_JAX_GRADS = {}


def _jax_grads(model, flax_vars, x, y):
    if model not in _JAX_GRADS:
        def value_and_grad(params, stats, x, y):
            def loss_fn(params):
                logits, mut = model.apply(
                    {"params": params, "batch_stats": stats}, x,
                    train=True, mutable=["batch_stats"])
                loss = optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()
                return loss, mut["batch_stats"]

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        _JAX_GRADS[model] = jax.jit(value_and_grad)
    (loss, stats), g = _JAX_GRADS[model](
        flax_vars["params"], flax_vars["batch_stats"], jnp.asarray(x),
        jnp.asarray(y))
    return float(loss), g, stats


def test_gradients_of_every_leaf():
    model = resnet.tiny()
    v = _variables(model)
    x, y = _batch()
    loss, grads, _ = _port_grads(model, v, x, y)
    want_loss, want, _ = _jax_grads(jresnet.tiny(), _to_flax(v), x, y)
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert _grads_close(_pairs(grads, want)) == len(
        jax.tree_util.tree_leaves(want))


def test_three_fused_sgd_steps():
    """3 train steps with ``fused_sgd(lr 0.1, momentum 0.9, wd 1e-4)``,
    the batch stats carried, each side from its own gradients: the
    params' displacement, all leaves together, within 1e-5 relative L2
    (2.8e-6 measured), each leaf within STEPS_LEAF_TOL, and the stats
    after the last step."""
    model = resnet.tiny()
    v = _variables(model)
    jm = jresnet.tiny()
    jv = _to_flax(v)
    tx = fused_sgd(lr=0.1, momentum=0.9, weight_decay=1e-4)
    jtx = jfused_sgd(lr=0.1, momentum=0.9, weight_decay=1e-4)
    state, jstate = tx.init(v["params"]), jtx.init(jv["params"])
    start = _to_flax(v["params"])
    params, stats = v["params"], v["batch_stats"]
    jparams, jstats = jv["params"], jv["batch_stats"]
    for step in range(3):
        x, y = _batch(seed=10 + step)
        _, grads, stats = _port_grads(
            model, {"params": params, "batch_stats": stats}, x, y)
        updates, state = tx.update(grads, state, params)
        with torch.no_grad():
            for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
                p.add_(u)
        _, jg, jstats = _jax_grads(jm, {"params": jparams,
                                        "batch_stats": jstats}, x, y)
        jupd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
    assert int(state.count) == 3
    moved = [(path, got - _get(start, path), ref - _get(start, path))
             for path, got, ref in _pairs(params, jparams)]
    assert _rel_l2(np.concatenate([g.ravel() for _, g, _ in moved]),
                   np.concatenate([r.ravel() for _, _, r in moved])) <= TOL
    for path, got, ref in moved:
        assert _rel_l2(got, ref) <= STEPS_LEAF_TOL, path
    for _, got, ref in _pairs(stats, jstats):
        _close(got, ref)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", ["stem_7x7_s2", "conv_3x3_s2",
                                  "max_pool_3x3_s2"])
def test_same_padding_is_flax_asymmetric(case):
    """At even sizes SAME pads (2, 3) for the 7x7/2 stem and (0, 1) for a
    3x3/2 convolution and the 3x3/2 max pool: equal to flax's, unequal to
    PyTorch's symmetric padding."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if case == "max_pool_3x3_s2":
        import flax.linen as nn

        got = resnet.max_pool(xt)
        want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                           padding="SAME")
        symmetric = F.max_pool2d(xt, 3, 2, padding=1)
    else:
        k = 7 if case == "stem_7x7_s2" else 3
        w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        got = resnet.conv(xt, wt, (2, 2))
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        symmetric = F.conv2d(xt, wt, stride=2, padding=k // 2)
    want = np.asarray(want)
    assert got.shape == symmetric.shape
    _close(got.permute(0, 2, 3, 1), want)
    assert not np.allclose(symmetric.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-2)


@pytest.mark.parametrize("stride_1x1", [False, True])
def test_bottleneck_stride_placement(stride_1x1):
    """A downsampling block, v1.5 (stride on the 3x3) and v1
    (``stride_1x1``: stride on the first 1x1), in train mode."""
    block = resnet.Bottleneck(8, (2, 2), stride_1x1=stride_1x1)
    v = block.init(torch.Generator().manual_seed(5), 16, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    y, stats = block.apply(v, torch.from_numpy(x), train=True)
    jb = jresnet.Bottleneck(8, (2, 2), stride_1x1=stride_1x1)
    want, mut = jb.apply(_to_flax(v), jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    assert y.shape == (2, 4, 4, 32)
    _close(y.detach(), want)
    for _, got, ref in _pairs(stats, mut["batch_stats"]):
        _close(got, ref)


def test_o2_cast_model_keeps_batchnorm_fp32():
    """amp O2 casts every leaf to bf16 but the ``BatchNorm_*`` ones, by
    their flax module paths, as the reference's policy does."""
    model = resnet.tiny()
    params = _variables(model)["params"]
    cast = amp.initialize(None, opt_level="O2", verbosity=0).policy \
        .cast_model(params)
    _, jhandle = jamp.initialize(
        jax.tree_util.tree_map(jnp.asarray, _to_flax(params)),
        opt_level="O2", verbosity=0)
    jcast = jhandle.policy.cast_model(_to_flax(params))
    n_bn = 0
    for path in _tree.paths(cast):
        want = torch.float32 if any(k.startswith("BatchNorm_")
                                    for k in path) else torch.bfloat16
        n_bn += want == torch.float32
        assert _get(cast, path).dtype == want, path
        assert str(_get(jcast, path).dtype) == str(want).split(".")[1], path
    assert n_bn == 2 * 9  # the stem's and 4 a block, scale and bias
    big = resnet.init_variables(torch.Generator().manual_seed(0),
                                resnet.resnet50(), device="meta")
    cast50 = amp.initialize(None, opt_level="O2", verbosity=0).policy \
        .cast_model(big["params"])
    fp32 = [p for p in _tree.paths(cast50)
            if _get(cast50, p).dtype == torch.float32]
    assert len(fp32) == 2 * 53 and all("BatchNorm" in p[-2] for p in fp32)


# -------------------------------------------------- sync_bn on 2 ranks


@pytest.fixture(scope="module")
def sync_ranks(tmp_path_factory):
    x, y = _batch(n=8, seed=7)
    return x, y, run_ranks("resnet", 2, tmp_path_factory.mktemp("resnet"),
                           {"x": x, "y": y})


def _jax_sync(x, y):
    """The reference's ``tiny(sync_bn=True)`` over a 2-device mesh: the
    logits, the new stats and the params' gradients of the ranks' mean
    CE (summed over the ranks: the transpose of the replicated params)."""
    model = resnet.tiny(sync_bn=True)
    fv = _to_flax(resnet.init_variables(torch.Generator().manual_seed(3),
                                        model, device="cpu"))
    jm = jresnet.tiny(sync_bn=True)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def f(params, x, y):
        def loss_fn(params):
            logits, mut = jm.apply(
                {"params": params, "batch_stats": fv["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, (logits, mut["batch_stats"])

        g, (logits, stats) = jax.grad(loss_fn, has_aux=True)(params)
        return logits, stats, g

    out = jax.jit(shard_map(f, mesh=mesh,
                            in_specs=(P(), P("data"), P("data")),
                            out_specs=(P("data"), P(), P())))(
        fv["params"], jnp.asarray(x), jnp.asarray(y))
    return fv, out


def _unflat(res, prefix):
    out = {}
    for k, v in res.items():
        if k.startswith(prefix + "/"):
            node = out
            parts = k.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(v)
    return out


def test_sync_bn_on_two_ranks_matches_the_reference(sync_ranks):
    """Logits, the new stats (UNBIASED running variance, momentum 0.1:
    the torch convention) and the gradients summed over the ranks."""
    x, y, ranks = sync_ranks
    fv, (logits, stats, grads) = _jax_sync(x, y)
    _close(np.concatenate([r["logits"] for r in ranks]), logits)
    for r in ranks:
        for _, got, ref in _pairs(_unflat(r, "stats"), stats):
            _close(got, ref)
    g0, g1 = (_unflat(r, "grads") for r in ranks)
    summed = _tree.unflatten(_tree.paths(g0), [
        a + b for a, b in zip(_tree.leaves(g0), _tree.leaves(g1))])
    _grads_close(_pairs(summed, grads))
    # the stem's running variance from the global batch's stem output
    stem = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(fv["params"]["Conv_0"]["kernel"]),
        (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        np.float64)
    new = ranks[0]["stats/BatchNorm_0/SyncBatchNorm_0/var"]
    unbiased = 0.9 + 0.1 * stem.var(axis=(0, 1, 2), ddof=1)
    _close(new, unbiased)
    # 2048 values a channel: the biased variance is 1/2047 smaller
    biased = 0.9 + 0.1 * stem.var(axis=(0, 1, 2))
    assert np.abs(new - biased).max() > 10 * np.abs(new - unbiased).max()


def test_example_step_equals_single_device_autograd(sync_ranks):
    """The imagenet example's DDP + SyncBatchNorm step on 2 ranks: its
    synced gradients equal one device's autograd over the global batch
    (the same port functions, nothing bound)."""
    x, y, ranks = sync_ranks
    model = resnet.tiny(sync_bn=True, axis_name=None)
    v = resnet.init_variables(torch.Generator().manual_seed(3), model,
                              device="cpu")
    loss, grads, _ = _port_grads(model, v, x, y)
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= TOL * abs(loss)
        _grads_close(_pairs(_unflat(r, "synced"), _to_flax(grads)))
