"""The port's multi-rank contrib paths on 2 gloo ranks on the CPU
(``tests/torch_contrib_suites.py``) against the JAX package's under
``shard_map`` over 2 simulated devices, the same numpy inputs on both
sides, after ``tests/contrib/test_contrib.py`` ``TestHaloExchange``,
``TestHaloExchangers``, ``TestDistributedFusedAdam`` and
``tests/run_optimizers/test_distributed_lamb.py``:

- halo exchange (margins of 1 and 2 rows, along H and W) and the four
  exchangers: outputs and gradients exact (they move values);
- ``SpatialBottleneck`` on an H-split map with the BatchNorm statistics
  over the spatial group: against the reference's, and against one
  device's ``Bottleneck(stride_1x1=True)`` on the whole map (the output,
  the input's gradient and the params' gradients summed over the ranks),
  fp32 to BLOCK_RTOL/ATOL 1e-4 / 1e-5;
- ``BatchNorm2d_NHWC(bn_group=2)`` (add+ReLU) against the reference's
  and against one BatchNorm over the global batch;
- ``DistributedFusedAdam`` and ``DistributedFusedLAMB`` (an fp32 and a
  bf16 bucket, 3 steps) against the reference's params and state shards
  (the fp32 Adam arithmetic's RTOL/ATOL, 4e-6 / 2e-7 for the fp32 leaves;
  bf16 leaves within one bf16 ulp of the values and one of the step: the
  port's class sets a param to its master rounded once, the reference
  adds an update rounded first), and Adam against the replicated
  ``fused_adam(flat=True)`` on the mean grads: fp32 params bit for bit
  at 2 ranks, the gathered shards equal the replicated moments. The flat
  Adam kernel's plain version equals the reference's ``_math.adam_step``
  on a shard to the same RTOL/ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib import bottleneck as j_bottleneck
from apex_tpu.contrib import halo_exchangers as j_hx
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm
from apex_tpu.contrib.optimizers import (
    distributed_fused_adam as j_dist_adam,
    distributed_fused_lamb as j_dist_lamb,
)
from apex_tpu.contrib.peer_memory import halo_exchange_1d as j_halo
from apex_tpu.optimizers import _math as j_math
from apex_tpu_torch import _tree
from apex_tpu_torch.models import resnet
from apex_tpu_torch.ops import fused_adam_kernel as fak
from apex_tpu_torch.optimizers import fused_adam
from torch_dist_worker import run_ranks

N = 2
BLOCK_RTOL, BLOCK_ATOL = 1e-4, 1e-5
ADAM_RTOL, ADAM_ATOL = 4e-6, 2e-7
STEPS = 3


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ halo

def _halo_inputs():
    rng = np.random.default_rng(0)
    inp = {"map": _f32(rng, 2, 8, 3, 4), "left": _f32(rng, N, 2, 3),
           "right": _f32(rng, N, 2, 3), "wl": _f32(rng, N, 2, 3),
           "wr": _f32(rng, N, 2, 3)}
    for hh in (1, 2):
        inp[f"w{hh}"] = _f32(rng, N, 2, 4 + 2 * hh, 3, 4)
    return inp


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    inp = _halo_inputs()
    return inp, run_ranks("contrib_halo", N, tmp_path_factory.mktemp(
        "halo"), inp)


def _stacked(fn, *args):
    """``fn`` on each rank's row of the stacked ``args`` under
    shard_map; its outputs stacked by rank."""
    def body(*a):
        out = fn(*(x[0] for x in a))
        return jax.tree_util.tree_map(lambda t: t[None], out)

    return jax.jit(shard_map(body, mesh=_mesh("spatial"),
                             in_specs=(P("spatial"),) * len(args),
                             out_specs=P("spatial")))(*map(jnp.asarray, args))


@pytest.mark.parametrize("hh", [1, 2])
def test_halo_exchange_matches_reference(halo, hh):
    inp, ranks = halo
    slabs = np.stack([np.pad(inp["map"][:, r * 4:(r + 1) * 4],
                             ((0, 0), (hh, hh), (0, 0), (0, 0)))
                      for r in range(N)])

    def f(ys):
        return _stacked(lambda y: j_halo(y, hh, "spatial", h_dim=1), ys)

    want, vjp = jax.vjp(f, jnp.asarray(slabs))
    dwant = np.asarray(vjp(jnp.asarray(inp[f"w{hh}"]))[0])
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"halo{hh}"], np.asarray(want[r]))
        np.testing.assert_array_equal(res[f"halo{hh}_grad"], dwant[r])
    # rank 1's top margin is rank 0's last interior row(s), rank 0's
    # bottom margin rank 1's first; the outer margins stay 0
    np.testing.assert_array_equal(ranks[1]["halo1"][:, 0],
                                  inp["map"][:, 3])
    np.testing.assert_array_equal(ranks[0]["halo1"][:, -1],
                                  inp["map"][:, 4])
    assert (ranks[0]["halo1"][:, 0] == 0).all()


def test_peer_halo_exchanger_along_w(halo):
    inp, ranks = halo
    slabs = np.stack([np.pad(inp["map"][:, r * 4:(r + 1) * 4],
                             ((0, 0), (0, 0), (1, 1), (0, 0)))
                      for r in range(N)])
    want = _stacked(lambda y: j_halo(y, 1, "spatial", h_dim=2), slabs)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["peer_w"], np.asarray(want[r]))
        assert (res["pool"] == 0).all() and res["pool"].shape == (2, 3)


@pytest.mark.parametrize("name", ["NoComm", "AllGather", "SendRecv",
                                  "Peer"])
def test_halo_exchangers_match_reference(halo, name):
    inp, ranks = halo
    ex = getattr(j_hx, f"HaloExchanger{name}")(axis_name="spatial")

    def f(left, right):
        return _stacked(ex.left_right_halo_exchange, left, right)

    (li, ri), vjp = jax.vjp(f, jnp.asarray(inp["left"]),
                            jnp.asarray(inp["right"]))
    dl, dr = vjp((jnp.asarray(inp["wl"]), jnp.asarray(inp["wr"])))
    for r, res in enumerate(ranks):
        for key, want in (("li", li), ("ri", ri), ("dl", dl), ("dr", dr)):
            np.testing.assert_array_equal(res[f"{name}_{key}"],
                                          np.asarray(want[r]),
                                          err_msg=f"{name} {key} rank {r}")
    if name != "NoComm":
        assert (ranks[0][f"{name}_li"] == 0).all()
        assert (ranks[1][f"{name}_ri"] == 0).all()
        np.testing.assert_array_equal(ranks[1][f"{name}_li"],
                                      inp["right"][0])


# ------------------------------------------------------------ bottleneck

# (features, stride): no projection; a strided projection
BOTTLENECK_CASES = [(4, 1), (4, 2)]


def _bottleneck_inputs():
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    inp = {"cases": np.array(BOTTLENECK_CASES)}
    variables = []
    for c, (f, s) in enumerate(BOTTLENECK_CASES):
        cin = 16 if s == 1 else 8
        v = resnet.Bottleneck(f, (s, s), True, None, stride_1x1=True).init(
            gen, cin, device="cpu")
        # running stats away from their inits
        for leaf in _tree.leaves(v["batch_stats"]):
            leaf.add_(torch.rand(leaf.shape, generator=gen) * 0.1)
        variables.append(v)
        for path, leaf in zip(_tree.paths(v), _tree.leaves(v)):
            inp[f"c{c}p." + ".".join(path)] = leaf.numpy()
        inp[f"x{c}"] = _f32(rng, 2, 8, 6, cin)
        out_hw = 8 // s, 6 // s
        inp[f"dy{c}"] = _f32(rng, 2, out_hw[0], out_hw[1], 4 * f)
    return inp, variables


@pytest.fixture(scope="module")
def bottleneck_ranks(tmp_path_factory):
    inp, variables = _bottleneck_inputs()
    return inp, variables, run_ranks(
        "contrib_bottleneck", N, tmp_path_factory.mktemp("bottleneck"), inp)


def _to_flax(tree):
    """The port's variables as the reference's: OIHW -> HWIO."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(np.transpose(t.numpy(), (2, 3, 1, 0))
                              if t.dim() == 4 else t.numpy()), tree)


def _rank_sum(ranks, key):
    return sum(r[key] for r in ranks)


@pytest.mark.parametrize("c", range(len(BOTTLENECK_CASES)))
def test_spatial_bottleneck_is_one_device_bottleneck(bottleneck_ranks, c):
    inp, variables, ranks = bottleneck_ranks
    f, s = BOTTLENECK_CASES[c]
    block = resnet.Bottleneck(f, (s, s), True, None, stride_1x1=True)
    x = torch.tensor(inp[f"x{c}"], requires_grad=True)
    live = _tree.map_leaves(lambda t: t.clone().requires_grad_(),
                            variables[c]["params"])
    y, stats = block.apply({"params": live,
                            "batch_stats": variables[c]["batch_stats"]}, x)
    grads = torch.autograd.grad((y * torch.tensor(inp[f"dy{c}"])).sum(),
                                [x] + _tree.leaves(live))
    got_y = np.concatenate([r[f"y{c}"] for r in ranks], axis=1)
    got_dx = np.concatenate([r[f"dx{c}"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)
    np.testing.assert_allclose(got_dx, grads[0].numpy(), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)
    for path, g in zip(_tree.paths(live), grads[1:]):
        key = f"g{c}." + ".".join(path)
        np.testing.assert_allclose(_rank_sum(ranks, key), g.numpy(),
                                   rtol=BLOCK_RTOL, atol=BLOCK_ATOL,
                                   err_msg=key)
    for path, leaf in zip(_tree.paths(stats), _tree.leaves(stats)):
        for r in ranks:
            np.testing.assert_allclose(r[f"s{c}." + ".".join(path)],
                                       leaf.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c", range(len(BOTTLENECK_CASES)))
def test_spatial_bottleneck_matches_reference(bottleneck_ranks, c):
    inp, variables, ranks = bottleneck_ranks
    f, s = BOTTLENECK_CASES[c]
    jblock = j_bottleneck.SpatialBottleneck(
        f, (s, s), axis_name="spatial", sync_bn=True, bn_axis="spatial")
    jvars = _to_flax(variables[c])

    def run(params, x):
        def body(p, xl):
            y, new = jblock.apply({"params": p,
                                   "batch_stats": jvars["batch_stats"]},
                                  xl, mutable=["batch_stats"])
            return y
        return shard_map(body, mesh=_mesh("spatial"),
                         in_specs=(P(), P(None, "spatial")),
                         out_specs=P(None, "spatial"))(params, x)

    y, vjp = jax.vjp(jax.jit(run), jvars["params"],
                     jnp.asarray(inp[f"x{c}"]))
    dparams, dx = vjp(jnp.asarray(inp[f"dy{c}"]))
    got_y = np.concatenate([r[f"y{c}"] for r in ranks], axis=1)
    got_dx = np.concatenate([r[f"dx{c}"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_y, np.asarray(y), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)
    np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)
    flat = jax.tree_util.tree_flatten_with_path(dparams)[0]
    for path, want in flat:
        key = f"g{c}." + ".".join(p.key for p in path)
        got = _rank_sum(ranks, key)
        if got.ndim == 4:
            got = np.transpose(got, (2, 3, 1, 0))
        np.testing.assert_allclose(got, np.asarray(want), rtol=BLOCK_RTOL,
                                   atol=BLOCK_ATOL, err_msg=key)


# --------------------------------------------------------------- groupbn

def test_groupbn_bn_group_2_is_the_global_batch(tmp_path):
    rng = np.random.default_rng(2)
    inp = {"x": _f32(rng, 4, 3, 3, 8, scale=2.0) + 1.0,
           "z": _f32(rng, 4, 3, 3, 8), "dy": _f32(rng, 4, 3, 3, 8),
           "bnp.params.SyncBatchNorm_0.scale": 1 + _f32(rng, 8, scale=0.1),
           "bnp.params.SyncBatchNorm_0.bias": _f32(rng, 8, scale=0.1),
           "bnp.batch_stats.SyncBatchNorm_0.mean": _f32(rng, 8, scale=0.1),
           "bnp.batch_stats.SyncBatchNorm_0.var": 1 + np.abs(
               _f32(rng, 8, scale=0.1))}
    ranks = run_ranks("contrib_groupbn", N, tmp_path, inp)
    jvars = {c: {"SyncBatchNorm_0": {
        k: jnp.asarray(inp[f"bnp.{c}.SyncBatchNorm_0.{k}"])
        for k in (("scale", "bias") if c == "params" else ("mean", "var"))}}
        for c in ("params", "batch_stats")}
    jbn = JBatchNorm(8, bn_group=2, momentum=0.8, axis_name="data")

    def run(x, z):
        def body(xl, zl):
            y, new = jbn.apply(jvars, xl, zl, mutable=["batch_stats"])
            s = new["batch_stats"]["SyncBatchNorm_0"]
            return y, s["mean"], s["var"]
        return shard_map(body, mesh=_mesh("data"),
                         in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P(), P()),
                         check_vma=False)(x, z)

    (y, mean, var), vjp = jax.vjp(jax.jit(run), jnp.asarray(inp["x"]),
                                  jnp.asarray(inp["z"]))
    stats = {"SyncBatchNorm_0": {"mean": mean, "var": var}}
    dx = vjp((jnp.asarray(inp["dy"]), jnp.zeros_like(mean),
              jnp.zeros_like(var)))[0]
    got_y = np.concatenate([r["y"] for r in ranks])
    got_dx = np.concatenate([r["dx"] for r in ranks])
    np.testing.assert_allclose(got_y, np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=1e-4,
                               atol=1e-5)
    for k in ("mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(
                r[f"s.SyncBatchNorm_0.{k}"],
                np.asarray(stats["SyncBatchNorm_0"][k]), rtol=1e-5,
                atol=1e-6)
    # one BatchNorm over the global batch: the sync branch's statistics
    from apex_tpu_torch.models._common import BatchNorm

    pv = {c: {"SyncBatchNorm_0": {k: torch.tensor(np.asarray(v))
                                  for k, v in d["SyncBatchNorm_0"].items()}}
          for c, d in jvars.items()}
    whole, _ = BatchNorm(sync=True, axis_name=None, momentum=0.8)(
        pv["params"], pv["batch_stats"], torch.tensor(inp["x"]), True, -1)
    np.testing.assert_allclose(
        got_y, torch.relu(whole + torch.tensor(inp["z"])).numpy(),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ optimizers

def _opt_inputs():
    rng = np.random.default_rng(3)
    params = {"w": _f32(rng, 37, 5), "b": _f32(rng, 11, scale=0.1),
              "bf_w": _f32(rng, 6, 8)}
    inp = {"p." + k: v for k, v in params.items()}
    inp["steps"] = np.array(STEPS)
    for s in range(STEPS):
        for k, v in params.items():
            inp[f"g{s}.{k}"] = _f32(rng, N, *v.shape, scale=0.5 + s)
    return inp


@pytest.fixture(scope="module")
def opt_ranks(tmp_path_factory):
    inp = _opt_inputs()
    return inp, run_ranks("contrib_dist_opt", N,
                          tmp_path_factory.mktemp("dist_opt"), inp)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _reference_run(inp, make_tx):
    """The reference transform's params after each step and its final
    state shards (concatenated in rank order)."""
    keys = ("w", "b", "bf_w")
    params = {k: jnp.asarray(inp["p." + k], jnp.bfloat16 if k == "bf_w"
                             else jnp.float32) for k in keys}
    grads = {k: jnp.asarray(np.stack([inp[f"g{s}.{k}"]
                                      for s in range(STEPS)]),
                            params[k].dtype) for k in keys}
    tx = make_tx()

    def run(p, g):
        state = tx.init(p)
        out = []
        for s in range(STEPS):
            u, state = tx.update({k: v[s, 0] for k, v in g.items()},
                                 state, p)
            p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
            out.append(p)
        return out, (state.master_shard, state.mu_shard, state.nu_shard)

    return jax.jit(shard_map(run, mesh=_mesh("dp"),
                             in_specs=(P(), P(None, "dp")),
                             out_specs=(P(), P("dp")), check_vma=False))(
        params, grads)


def _ulp(a):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _close_params(got, want, key, old=None):
    """fp32 leaves to the Adam arithmetic's tolerance; a bf16 leaf within
    one bf16 ulp of the larger of the values and of the step from
    ``old``: the port's class sets a param to its master rounded once,
    the reference's transform adds the update rounded first."""
    if key.split(".")[-1].startswith("bf"):
        old = want if old is None else old
        bound = _ulp(np.maximum(np.abs(got), np.abs(want))) + _ulp(
            want - old)
        assert np.all(np.abs(got - want) <= bound), key
    else:
        np.testing.assert_allclose(got, want, rtol=ADAM_RTOL,
                                   atol=ADAM_ATOL, err_msg=key)


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_distributed_optimizers_match_reference(opt_ranks, name):
    inp, ranks = opt_ranks
    make = {"adam": lambda: j_dist_adam(lr=1e-2, weight_decay=0.01,
                                        axis_name="dp"),
            "lamb": lambda: j_dist_lamb(lr=1e-2, eps=1e-6,
                                        weight_decay=0.01,
                                        max_grad_norm=1.0,
                                        axis_name="dp")}[name]
    per_step, shards = _reference_run(inp, make)
    for s in range(STEPS):
        for k in ("w", "b", "bf_w"):
            want = np.asarray(per_step[s][k].astype(jnp.float32))
            old = (_bf16(inp["p." + k]) if s == 0 else
                   np.asarray(per_step[s - 1][k].astype(jnp.float32)))
            for r in ranks:
                _close_params(r[f"{name}{s}.{k}"], want, f"{name}{s}.{k}",
                              old)
    np.testing.assert_array_equal(ranks[0][f"{name}{STEPS - 1}.w"],
                                  ranks[1][f"{name}{STEPS - 1}.w"])
    for field, want in zip(("master_shard", "mu_shard", "nu_shard"),
                           shards):
        for k, v in want.items():
            got = np.concatenate([r[f"{name}_{field}.{k}"] for r in ranks])
            np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{field}.{k}")
    assert all(int(r[f"{name}_count"]) == STEPS for r in ranks)


def test_distributed_adam_is_the_replicated_flat_step(opt_ranks):
    """At 2 ranks each reduced element is a + b, so the sharded step is
    the replicated ``fused_adam(flat=True)`` step on the mean grads: the
    fp32 params bit for bit, the gathered m and v shards the replicated
    slabs; the bf16 params are the fp32 masters rounded, where the
    replicated step rounds each update, so within one bf16 ulp."""
    inp, ranks = opt_ranks
    params = {k: torch.tensor(inp["p." + k]) for k in ("w", "b", "bf_w")}
    params["bf_w"] = params["bf_w"].bfloat16()
    tx = fused_adam(lr=1e-2, weight_decay=0.01, flat=True)
    state = tx.init(params)
    for s in range(STEPS):
        grads = {k: (torch.tensor(inp[f"g{s}.{k}"][0]).to(v.dtype).float()
                     + torch.tensor(inp[f"g{s}.{k}"][1]).to(v.dtype)
                     .float()) / 2 for k, v in params.items()}
        u, state = tx.update(grads, state, params)
        for k in params:
            params[k] = params[k] + u[k]
        for k in ("w", "b"):
            np.testing.assert_array_equal(ranks[0][f"adam{s}.{k}"],
                                          params[k].numpy(), err_msg=k)
        _close_params(ranks[0][f"adam{s}.bf_w"],
                      params["bf_w"].float().numpy(), "bf_w",
                      (params["bf_w"] - u["bf_w"]).float().numpy())
    for field, slab in (("mu_shard", state.mu), ("nu_shard", state.nu)):
        got = np.concatenate([r[f"adam_{field}.float32"] for r in ranks])
        np.testing.assert_array_equal(got[:slab["float32"].numel()],
                                      slab["float32"].numpy())
    assert "('dp',)" in str(ranks[0]["specs"])


def test_adam_flat_plain_is_the_reference_adam_step():
    """The shard step's arithmetic: ``_adam_flat_plain`` (the kernel's
    plain version) against ``apex_tpu.optimizers._math.adam_step`` on one
    shard, AdamW and L2 mode."""
    rng = np.random.default_rng(4)
    g, p = _f32(rng, 4099), _f32(rng, 4099)
    m, v = _f32(rng, 4099, scale=0.1), np.abs(_f32(rng, 4099, scale=0.01))
    for adam_w_mode in (True, False):
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                  adam_w_mode=adam_w_mode, bias_correction=True)
        mt, vt = torch.tensor(m), torch.tensor(v)
        delta, mt, vt = fak._adam_flat_plain(
            torch.tensor(g), torch.tensor(p), mt, vt, 1e-3,
            torch.tensor(3.0), **kw)
        jd, jm, jv = j_math.adam_step(
            jnp.asarray(g), jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
            lr=1e-3, step=jnp.float32(3.0), **kw)
        for got, want in ((delta, jd), (mt, jm), (vt, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=ADAM_RTOL, atol=ADAM_ATOL)
