"""The port's process groups, divergence check, DDP and overlap engine
(``apex_tpu_torch.distributed``, ``apex_tpu_torch.parallel``) held
against the JAX package's.

Each fixture runs one suite of ``tests/torch_dist_worker.py`` on gloo
ranks on the CPU, once for the module; the reference runs as its own
tests run it, under ``shard_map`` over ``Mesh(jax.devices()[:n])`` on
the simulated host devices that ``tests/conftest.py`` forces. Both get
the same numpy inputs.

Tolerances: digests, bucket plans, integer results and sums of two
ranks' fp32 values are exact (a + b is the same float either way, and
the predivide chain is the same IEEE operations); the backend suite's
sums over 4 ranks are held at 1e-6 relative (gloo and XLA may add four
terms in other orders), and so are a model's grads (GRAD_RTOL: two
autograds round in their own order). Within the port, the sync paths are compared bit
for bit at 2 ranks, as the reference compares them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import distributed as jdist
from apex_tpu import parallel as jpar
from apex_tpu.distributed import divergence as jdiv
from apex_tpu.runtime import bucket_offsets as j_bucket_offsets
from apex_tpu.runtime import plan_buckets as j_plan_buckets
from apex_tpu_torch.distributed import backend as B
from apex_tpu_torch.distributed import divergence as pdiv
from apex_tpu_torch import parallel as ppar
from apex_tpu_torch.runtime import bucket_offsets, plan_buckets
from torch_dist_worker import run_ranks

RTOL4 = 1e-6
# a model's local grads come from two autograds (torch's, XLA's), whose
# products and sums round in their own order: a few fp32 ulps apart
GRAD_RTOL = 1e-6


def _mesh(n, names=("dp",)):
    return Mesh(np.array(jax.devices()[:n]), names)


def _backend_inputs():
    rng = np.random.default_rng(0)
    return {"ops": np.arange(4.0, dtype=np.float32) + 1.0,
            "gather": np.arange(8.0, dtype=np.float32).reshape(4, 2),
            "bcast": np.arange(4.0, dtype=np.float32).reshape(4, 1) * 100,
            "a2a": np.arange(16.0, dtype=np.float32).reshape(4, 4),
            "div_a": rng.standard_normal((8, 16)).astype(np.float32),
            "div_b": rng.standard_normal(32).astype(np.float32)}


@pytest.fixture(scope="module")
def backend_ranks(tmp_path_factory):
    inputs = _backend_inputs()
    return inputs, run_ranks("backend", 4, tmp_path_factory.mktemp("bk"),
                             inputs)


def _ddp_inputs():
    rng = np.random.default_rng(1)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"lin_w": np.ones((4, 1), np.float32), "lin_x": f32(16, 4),
            "lin_y": f32(16, 1), "ones": np.ones((2, 1, 2), np.float32),
            "pre_x": f32(2, 1, 3), "par_w": f32(2, 33, 3),
            "par_b": f32(2, 17), "ddp_x": f32(2, 1, 24),
            "mix_plain": np.arange(4.0, dtype=np.float32),
            "mix_cvjp": np.arange(4.0, dtype=np.float32) + 1,
            "mix_x": f32(16, 4), "ov_a": f32(2, 33, 7), "ov_b": f32(2, 129),
            "ov_c": f32(2, 5, 6), "mlp_w1": f32(16, 16), "mlp_w2": f32(16, 4),
            "mlp_b": f32(4), "mlp_x": f32(32, 16), "mlp_y": f32(32, 4)}


@pytest.fixture(scope="module")
def ddp_ranks(tmp_path_factory):
    inputs = _ddp_inputs()
    return inputs, run_ranks("ddp", 2, tmp_path_factory.mktemp("ddp"),
                             inputs)


def _per_rank(fn, x, n, names=("dp",)):
    """``fn`` on each rank's row of ``x`` under shard_map; the stacked
    per-rank results."""
    out = jax.jit(shard_map(lambda v: fn(v[0])[None], mesh=_mesh(n, names),
                            in_specs=P(names), out_specs=P(names)))(
        jnp.asarray(x))
    return np.asarray(out)


# ---------------------------------------------------------------- backend

@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PRODUCT"])
def test_all_reduce_ops(backend_ranks, op):
    inputs, ranks = backend_ranks
    want = _per_rank(lambda v: jdist.all_reduce(
        v, getattr(jdist.ReduceOp, op), "dp"), inputs["ops"][:, None], 4)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"op_{op}"], want[r], rtol=RTOL4)


def test_gather_scatter_roundtrip(backend_ranks):
    inputs, ranks = backend_ranks
    x = inputs["gather"]
    full = _per_rank(lambda v: jdist.all_gather(v, "dp"), x, 4)
    stacked = _per_rank(lambda v: jdist.all_gather(v, "dp", tiled=False),
                        x, 4)
    axis1 = _per_rank(lambda v: jdist.all_gather(v[None], "dp", axis=1),
                      x, 4)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["gather"], full[r])
        np.testing.assert_array_equal(res["gather_stacked"], stacked[r])
        np.testing.assert_array_equal(res["gather_axis1"], axis1[r])
        np.testing.assert_allclose(res["roundtrip"], x[r], rtol=RTOL4)


def test_broadcast(backend_ranks):
    inputs, ranks = backend_ranks
    want = _per_rank(lambda v: jdist.broadcast(v, src=2, group="dp"),
                     inputs["bcast"], 4)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["bcast"], want[r])


def test_all_to_all(backend_ranks):
    inputs, ranks = backend_ranks
    x = inputs["a2a"]
    got = jax.jit(shard_map(
        lambda v: jdist.all_to_all(v, "dp", split_axis=1, concat_axis=0),
        mesh=_mesh(4), in_specs=P("dp", None), out_specs=P(None, "dp")))(
        jnp.asarray(x))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["a2a"], np.asarray(got)[:, r:r + 1])


def test_host_init(backend_ranks):
    _, ranks = backend_ranks
    for res in ranks:
        assert res["init"].tolist() == [1, 4, 4]


def test_tuple_group_reductions_and_broadcast(backend_ranks):
    """A 2 x 2 grid of groups: the tuple reduces over both axes, the
    composite rank and a broadcast over the tuple bound whole follow the
    reference's (``test_backend.py:74``)."""
    inputs, ranks = backend_ranks
    x = jnp.asarray(inputs["ops"][:, None])
    names = ("dp", "tp")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), names)
    cases = {
        "grid_sum": lambda u: jdist.all_reduce(u, jdist.ReduceOp.SUM, names),
        "grid_avg": lambda u: jdist.all_reduce(u, jdist.ReduceOp.AVG, names),
        "grid_row_sum": lambda u: jdist.all_reduce(u, jdist.ReduceOp.SUM,
                                                   "tp"),
        "grid_bcast": lambda u: jdist.broadcast(u, src=3, group=names)}
    for key, fn in cases.items():
        per = np.asarray(jax.jit(shard_map(
            lambda v, fn=fn: fn(v[0])[None], mesh=mesh, in_specs=P(names),
            out_specs=P(names)))(x))
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[key], per[r], rtol=RTOL4,
                                       err_msg=key)
    for r, res in enumerate(ranks):
        assert int(res["grid_rank"]) == r


def test_all_reduce_is_differentiable(backend_ranks):
    """The gradient of a rank's input through a SUM is the sum of every
    rank's output gradient, the transpose of the reference's psum."""
    inputs, ranks = backend_ranks
    for res in ranks:
        np.testing.assert_array_equal(res["grad_all_reduce"],
                                      [10.0 * inputs["ops"].sum()])


def test_unbound_axis_and_nccl_on_one_device_raise(monkeypatch):
    with pytest.raises(NameError, match="unbound axis name: 'nope'"):
        B.all_reduce(torch.ones(2), group="nope")
    with pytest.raises(ValueError, match="backend must be one of"):
        B.init_process_group("mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                         "device"):
        B.init_process_group("nccl")
    assert not B.is_initialized()


# ------------------------------------------------------------- divergence

def _digest_trees():
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    return [
        {"a": f32, "b": rng.standard_normal(33).astype(np.float32)},
        {"bf16": f32.astype(jnp.bfloat16), "i32": np.arange(9, dtype=np.int32),
         "u8": (np.arange(300) % 256).astype(np.uint8)},
        {"fp8": f32.astype(jnp.float8_e4m3fn), "z": np.zeros((), np.float32),
         "f16": f32.astype(np.float16)},
    ]


def _port_leaf(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", range(3))
def test_digest_equals_reference_bit_for_bit(case):
    """The uint32 hash of the same tree, exactly, for fp32, bf16, fp16,
    fp8, int32, uint8 and 0-dim leaves (bits read, never cast)."""
    tree = _digest_trees()[case]
    jh, jmag = jdiv._fingerprint(
        {k: jnp.asarray(v) for k, v in tree.items()})
    ph, pmag = pdiv._fingerprint({k: _port_leaf(v) for k, v in tree.items()})
    assert ph == int(np.asarray(jh))
    np.testing.assert_allclose(float(pmag), float(jmag), rtol=1e-5,
                               atol=1e-5)


def test_replica_divergence_verdicts(backend_ranks):
    """Identical replicas 0; a 1e-3 drift on one rank and a permutation
    (the same multiset of values) detected; every rank's digest of its
    own tree equals the reference's (``test_divergence.py``)."""
    inputs, ranks = backend_ranks
    tree = {"a": jnp.asarray(inputs["div_a"]),
            "b": jnp.asarray(inputs["div_b"])}
    same = int(np.asarray(jdiv._fingerprint(tree)[0]))
    drift = dict(tree, a=tree["a"].at[0, 0].add(1e-3))
    drifted = int(np.asarray(jdiv._fingerprint(drift)[0]))
    for r, res in enumerate(ranks):
        assert int(res["digest_same"]) == same
        assert int(res["digest_drift"]) == (drifted if r == 3 else same)
        assert float(res["div_same"]) == 0.0
        assert not bool(res["drift_ok"]) and float(res["drift_div"]) > 0.0
        assert not bool(res["perm_ok"])


def test_divergence_monitor_latches(backend_ranks):
    _, ranks = backend_ranks
    for res in ranks:
        assert int(res["mon_checks"]) == 2 and not bool(res["mon_clean"])
        assert bool(res["mon_poisoned"]) and float(res["mon_max"]) > 0.0
        assert bool(res["mon_latched"])
        # one rank's force makes every rank digest
        assert int(res["mon_forced_checks"]) == 1


# ---------------------------------------------------------------- buckets

@pytest.mark.parametrize("sizes,cap", [
    ([100, 200, 300, 400], 450), ([10] * 7, 25), ([5000, 1, 1, 5000], 4096),
    ([], 10), ([3], 1)])
def test_plan_buckets_equal_reference(sizes, cap):
    ids = plan_buckets(sizes, cap)
    assert ids == list(j_plan_buckets(sizes, cap))
    assert bucket_offsets(sizes, ids) == tuple(
        list(x) for x in j_bucket_offsets(sizes, ids)) or \
        list(bucket_offsets(sizes, ids)) == [
            list(x) for x in j_bucket_offsets(sizes, ids)]


def _plans_equal(pplan, jplan):
    assert pplan.n_leaves == jplan.n_leaves
    assert pplan.num_shards == jplan.num_shards
    assert [(b.dtype, b.indices, b.shapes, b.sizes, b.total, b.padded)
            for b in pplan.buckets] == [
        (b.dtype, b.indices, b.shapes, b.sizes, b.total, b.padded)
        for b in jplan.buckets]
    assert pplan.total_bytes() == jplan.total_bytes()


def test_plan_overlap_grad_ready_order():
    tree = {f"p{i:02d}": np.zeros(256, np.float32) for i in range(8)}
    pplan = ppar.plan_overlap({k: torch.from_numpy(v)
                               for k, v in tree.items()}, 2 / 1024)
    jplan = jpar.plan_overlap({k: jnp.asarray(v) for k, v in tree.items()},
                              bucket_cap_mb=2 / 1024)
    _plans_equal(pplan, jplan)
    assert pplan.buckets[0].indices == (6, 7)


def test_plan_overlap_groups_per_dtype_and_pads():
    ptree = {"w": torch.zeros(100), "h": torch.zeros(50,
                                                     dtype=torch.bfloat16)}
    jtree = {"w": jnp.zeros(100), "h": jnp.zeros(50, jnp.bfloat16)}
    _plans_equal(ppar.plan_overlap(ptree, 10.0, num_shards=8),
                 jpar.plan_overlap(jtree, 10.0, num_shards=8))


def test_grad_sync_comms_bytes_zero1_ratio():
    ptree = {"w": torch.zeros(512, 256, dtype=torch.bfloat16),
             "b": torch.zeros(256, dtype=torch.bfloat16)}
    jtree = {"w": jnp.zeros((512, 256), jnp.bfloat16),
             "b": jnp.zeros((256,), jnp.bfloat16)}
    for mode in ("allreduce", "zero1"):
        for n in (1, 2, 8):
            assert ppar.grad_sync_comms_bytes(ptree, n, mode) == \
                jpar.grad_sync_comms_bytes(jtree, n, mode)
    assert ppar.grad_sync_comms_bytes(ptree, 8, "zero1") * 4 == \
        ppar.grad_sync_comms_bytes(ptree, 8, "allreduce") * 3
    with pytest.raises(ValueError, match="unknown grad-sync mode"):
        ppar.grad_sync_comms_bytes(ptree, 8, "broadcast")


# -------------------------------------------------------------------- DDP

def _jax_ddp(fn, *args, n=2, in_specs=None, out_specs=P("data"),
             check_vma=True):
    """``fn`` under shard_map over a 2-device ``"data"`` axis."""
    return jax.jit(shard_map(fn, mesh=_mesh(n, ("data",)), in_specs=in_specs,
                             out_specs=out_specs, check_vma=check_vma))(*args)


def test_replicated_params_grads_autoreduced_then_averaged(ddp_ranks):
    """The reference's grads arrive summed and ``average_reduced``
    divides; the port sums local grads first (``sync_gradients`` without
    averaging), then the same ``average_reduced``."""
    inputs, ranks = ddp_ranks
    w, x, y = (jnp.asarray(inputs[k]) for k in ("lin_w", "lin_x", "lin_y"))

    def local_loss(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    want = _jax_ddp(lambda w, x, y: jpar.average_reduced(
        {"w": jax.grad(local_loss)(w, x, y)}, "data")["w"], w, x, y,
        in_specs=(P(), P("data"), P("data")), out_specs=P())
    for res in ranks:
        np.testing.assert_allclose(res["avg_reduced"], np.asarray(want),
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("flat", [False, True])
def test_synced_local_grads_equal_global_batch_grads(ddp_ranks, flat):
    inputs, ranks = ddp_ranks
    w, x, y = (jnp.asarray(inputs[k]) for k in ("lin_w", "lin_x", "lin_y"))
    sync = jpar.sync_gradients_flat if flat else jpar.sync_gradients

    def local_loss(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    def shard_fn(w, x, y):
        g = jax.grad(local_loss)(jax.lax.pvary(w, ("data",)), x, y)
        return sync({"w": g}, axis_name="data")["w"][None]

    want = _jax_ddp(shard_fn, w, x, y, in_specs=(P(), P("data"), P("data")),
                    out_specs=P("data"))
    g_ref = jax.grad(local_loss)(w, x, y)
    for r, res in enumerate(ranks):
        got = res["synced_flat" if flat else "synced"]
        np.testing.assert_allclose(got, np.asarray(want)[r], rtol=GRAD_RTOL)
        np.testing.assert_allclose(got, np.asarray(g_ref), rtol=1e-5)


def test_psum_without_average(ddp_ranks):
    _, ranks = ddp_ranks
    for res in ranks:
        np.testing.assert_array_equal(res["noavg"], 2.0 * np.ones((1, 2)))


def test_predivide_factor_matches_plain_mean(ddp_ranks):
    inputs, ranks = ddp_ranks
    for r, res in enumerate(ranks):
        want = _jax_ddp(lambda v: jpar.sync_gradients(
            {"g": v}, "data", gradient_predivide_factor=4.0)["g"],
            jnp.asarray(inputs["pre_x"].reshape(2, 3)), in_specs=P("data"),
            out_specs=P("data"))
        np.testing.assert_array_equal(res["pre4.0"][0], np.asarray(want)[r])
        np.testing.assert_allclose(res["pre1.0"], res["pre4.0"], rtol=1e-5)


@pytest.mark.parametrize("pre", [1.0, 4.0, 0.5])
def test_predivide_factor_parity_across_sync_paths(ddp_ranks, pre):
    """plain, flat and bucketed: bit-identical to each other, and to the
    reference's, for any factor."""
    inputs, ranks = ddp_ranks
    g = {"w": jnp.asarray(inputs["par_w"]).reshape(2 * 33, 3),
         "b": jnp.asarray(inputs["par_b"]).reshape(2 * 17)}
    want = _jax_ddp(lambda g: jpar.sync_gradients(
        g, "data", gradient_predivide_factor=pre), g, in_specs=P("data"),
        out_specs=P("data"))
    for r, res in enumerate(ranks):
        for k, rows in (("w", 33), ("b", 17)):
            ref = np.asarray(want[k])[r * rows:(r + 1) * rows]
            for path in ("plain", "flat", "bucketed"):
                np.testing.assert_array_equal(
                    res[f"par_{path}_{pre}_{k}"], ref,
                    err_msg=f"{path} pre={pre} {k}")


def test_ddp_wrapper_sync_and_delay(ddp_ranks):
    inputs, ranks = ddp_ranks
    x = inputs["ddp_x"]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["ddp_kept"], x[r])
        np.testing.assert_array_equal(res["ddp_synced"], res["ddp_forced"])
        np.testing.assert_allclose(res["ddp_synced"], x.mean(0), rtol=1e-6)
        assert res["wrapped_call"].shape == (1, 1)


def test_ddp_always_fp32_reduction_preserves_dtype(ddp_ranks):
    inputs, ranks = ddp_ranks
    xb = jnp.asarray(inputs["ddp_x"]).reshape(2, 24).astype(jnp.bfloat16)
    ddp = jpar.DistributedDataParallel(axis_name="data",
                                       allreduce_always_fp32=True)
    want = _jax_ddp(lambda v: ddp.sync({"g": v})["g"], xb,
                    in_specs=P("data"), out_specs=P("data"))
    for r, res in enumerate(ranks):
        assert bool(res["fp32_dtype_bf16"])
        np.testing.assert_array_equal(
            res["fp32_bits"][0], np.asarray(want)[r].view(np.int16))


def test_reducer(ddp_ranks):
    _, ranks = ddp_ranks
    for res in ranks:
        np.testing.assert_array_equal(res["reducer"], [0.5])


def test_shared_param_rejected():
    with pytest.raises(ValueError):
        ppar.DistributedDataParallel(shared_param=True)


def test_sync_autodiff_gradients_mean_reduces_local_grads(ddp_ranks):
    """The reference's mixed tree (``test_ddp.py:210``: auto-summed and
    custom_vjp-local leaves) must land the global-batch mean gradient,
    ``jax.grad`` of the loss over the whole batch; the port's leaves are
    all local and reach the same mean (held at the reference test's
    1e-5: a mean of two half-batch means against one mean)."""
    inputs, ranks = ddp_ranks
    params = {"plain": jnp.asarray(inputs["mix_plain"]),
              "cvjp": jnp.asarray(inputs["mix_cvjp"])}

    def loss(p, x):
        return jnp.mean((x * p["plain"]) ** 2 + (x * p["cvjp"]) ** 2)

    want = jax.grad(loss)(params, jnp.asarray(inputs["mix_x"]))
    for res in ranks:
        for k in params:
            np.testing.assert_allclose(res[f"mix_{k}"], np.asarray(want[k]),
                                       rtol=1e-5, err_msg=k)
            np.testing.assert_array_equal(res[f"ddp_avg_{k}"],
                                          res[f"mix_{k}"])


# ---------------------------------------------------------------- overlap

@pytest.mark.parametrize("pre,average", [(1.0, True), (4.0, True),
                                         (1.0, False)])
def test_overlapped_sync_bit_identical_to_single_psum(ddp_ranks, pre,
                                                      average):
    inputs, ranks = ddp_ranks
    g = {k: jnp.asarray(inputs[f"ov_{k}"]).reshape(
        (-1,) + inputs[f"ov_{k}"].shape[2:]) for k in ("a", "b", "c")}
    want = _jax_ddp(lambda g: jpar.sync_gradients_overlapped(
        g, "data", gradient_average=average, gradient_predivide_factor=pre,
        bucket_cap_mb=0.0005), g, in_specs=P("data"), out_specs=P("data"))
    for r, res in enumerate(ranks):
        for k in g:
            got = res[f"ov_{pre}_{average}_{k}"]
            np.testing.assert_array_equal(got,
                                          res[f"ov_ref_{pre}_{average}_{k}"])
            rows = got.shape[0]
            np.testing.assert_array_equal(
                got, np.asarray(want[k])[r * rows:(r + 1) * rows])


def test_single_bucket_degenerates_to_flat_psum(ddp_ranks):
    _, ranks = ddp_ranks
    for res in ranks:
        for k in ("a", "b", "c"):
            np.testing.assert_array_equal(res[f"ov_one_{k}"],
                                          res[f"ov_ref_1.0_True_{k}"])


def test_plan_mismatch_is_loud(ddp_ranks):
    _, ranks = ddp_ranks
    for res in ranks:
        assert "diverged" in str(res["ov_plan_mismatch"])


def test_overlapped_value_and_grad_backward_hooks(ddp_ranks):
    """Reduced inside the backward, bucket by bucket: bit-identical to
    autograd + sync_gradients, and to the reference's."""
    inputs, ranks = ddp_ranks
    params = {k: jnp.asarray(inputs[f"mlp_{k}"]) for k in ("w1", "w2", "b")}

    def loss(p, x, y):
        h = jnp.tanh(x @ p["w1"])
        return jnp.mean((h @ p["w2"] + p["b"] - y) ** 2)

    def f(p, x, y):
        return jpar.overlapped_value_and_grad(
            loss, axis_name="data", bucket_cap_mb=0.0005)(p, x, y)

    jl, jg = _jax_ddp(f, params, jnp.asarray(inputs["mlp_x"]),
                      jnp.asarray(inputs["mlp_y"]),
                      in_specs=(P(), P("data"), P("data")),
                      out_specs=(P(), P()), check_vma=False)
    np.testing.assert_allclose(ranks[0]["vg_loss"], np.asarray(jl),
                               rtol=GRAD_RTOL)  # rank 0's local loss
    for r, res in enumerate(ranks):
        assert np.isfinite(res["vg_loss"])
        for k in params:
            np.testing.assert_array_equal(res[f"vg_{k}"], res[f"vg_ref_{k}"])
            # an element near 0 is a sum of O(1) terms: a few of their
            # ulps apart, so an absolute floor of 1e-6
            np.testing.assert_allclose(res[f"vg_{k}"], np.asarray(jg[k]),
                                       rtol=1e-5, atol=1e-6)
        assert float(res["vg_aux"]) == 7.0
        # a leaf the loss does not reach: zeros, as its cotangent is in
        # the reference; the others unchanged
        np.testing.assert_array_equal(res["vg_unused"], np.zeros(3))
        np.testing.assert_array_equal(res["vg_unused_w1"], res["vg_w1"])


def test_overlapped_buckets_issue_in_backward_order(ddp_ranks):
    """Every bucket is issued once, from inside the backward; w1's (used
    first in the forward) completes last."""
    _, ranks = ddp_ranks
    for res in ranks:
        order, first_leaf = res["vg_issue_order"], res["vg_bucket_leaves"]
        assert sorted(order.tolist()) == list(range(len(first_leaf)))
        leaf_of_last = first_leaf[order[-1]]
        assert leaf_of_last == 1  # leaves in JAX order: b, w1, w2


def test_ddp_wrapper_overlap_mode(ddp_ranks):
    _, ranks = ddp_ranks
    for res in ranks:
        np.testing.assert_array_equal(res["ddp_plain"], res["ddp_over"])
