"""ZeRO-1 FusedAdam of the port (``apex_tpu_torch.parallel.zero``) on 2
gloo ranks on the CPU, held against its contract and the JAX package's
``Zero1FusedAdam`` under ``shard_map`` over 2 simulated devices
(``tests/run_parallel/test_zero1.py``), from the same numpy params and
per-rank grads.

Tolerances: within the port, ZeRO-1 equals ``sync_gradients`` plus a
replicated ``fused_adam(flat=True)`` bit for bit (params and moments, 3
steps: at 2 ranks each reduced element is a + b whichever collective
sums it). Against the reference, the fp32 Adam arithmetic agrees to
RTOL/ATOL of ``tests/test_torch_fused_adam.py`` (XLA may contract a
product and a sum into one FMA); bf16 params within one bf16 ulp. Plans,
layouts and the checkpoint schema's fingerprint are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.checkpoint import state_schema_of as j_state_schema_of
from apex_tpu.parallel import Zero1FusedAdam as JZero1
from apex_tpu.parallel import grad_sync_comms_bytes as j_comms
from apex_tpu_torch.parallel import Zero1FusedAdam, grad_sync_comms_bytes
from torch_dist_worker import run_ranks

RTOL, ATOL = 4e-6, 2e-7
STEPS = 3


def _inputs():
    rng = np.random.default_rng(3)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = {"zp_w": f32(37, 11), "zp_b": f32(13), "bf_w": f32(24, 16),
           "bf_g": f32(2, 24, 16)}
    for step in range(STEPS):
        out[f"zg{step}_w"], out[f"zg{step}_b"] = f32(2, 37, 11), f32(2, 13)
    return out


@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("zero1", 2, tmp_path_factory.mktemp("zero1"),
                             inputs)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def _jax_zero1_run(inputs):
    """The reference's ZeRO-1 over the 3 steps: params after each step
    and the final global state."""
    opt = JZero1(lr=1e-2, weight_decay=0.01, axis_name="dp", num_shards=2,
                 bucket_cap_mb=0.0005)
    params = {k: jnp.asarray(inputs[f"zp_{k}"]) for k in ("w", "b")}
    state = opt.init(params)
    specs = opt.state_specs(params)
    step = jax.jit(shard_map(
        lambda p, s, g: opt.step(jax.tree_util.tree_map(lambda a: a[0], g),
                                 s, p),
        mesh=_mesh(), in_specs=(P(), specs, P("dp")),
        out_specs=(P(), specs), check_vma=False))
    per_step = []
    for i in range(STEPS):
        g = {k: jnp.asarray(inputs[f"zg{i}_{k}"]) for k in ("w", "b")}
        params, state = step(params, state, g)
        per_step.append(jax.tree_util.tree_map(np.asarray, params))
    return opt, params, state, per_step


def test_zero1_bit_identical_to_replicated_fused_adam(zero_ranks):
    """THE contract (``test_zero1.py:60``): each ZeRO-1 step equals synced
    grads plus a replicated flat fused Adam step, bitwise, params and
    moments, and the step counters agree."""
    _, ranks = zero_ranks
    for res in ranks:
        for step in range(STEPS):
            for k in ("w", "b"):
                np.testing.assert_array_equal(
                    res[f"z_{step}_{k}"], res[f"r_{step}_{k}"],
                    err_msg=f"params[{k}] step {step}")
        assert int(res["z_count"]) == STEPS == int(res["r_count"])
        # the replicated slab packs b then w (JAX leaf order)
        for name in ("mu", "nu"):
            flat = np.concatenate([res[f"z{name}_b"].ravel(),
                                   res[f"z{name}_w"].ravel()])
            np.testing.assert_array_equal(flat, res[f"r{name}"])
    np.testing.assert_array_equal(ranks[0]["z_2_w"], ranks[1]["z_2_w"])


def test_zero1_matches_reference(zero_ranks):
    inputs, ranks = zero_ranks
    opt, _, state, per_step = _jax_zero1_run(inputs)
    mu, nu = opt.unpack_state(per_step[-1], state)
    for res in ranks:
        for step in range(STEPS):
            for k in ("w", "b"):
                np.testing.assert_allclose(res[f"z_{step}_{k}"],
                                           per_step[step][k], rtol=RTOL,
                                           atol=ATOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(res[f"zmu_{k}"], np.asarray(mu[k]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(res[f"znu_{k}"], np.asarray(nu[k]),
                                       rtol=RTOL, atol=ATOL)
        assert int(res["n_buckets"]) == len(state.mu)


def test_zero1_state_is_sharded_and_smaller(zero_ranks):
    """Each rank holds ``padded / n`` of each bucket; the global buffers
    reassemble, in element order, what the rank shards hold."""
    inputs, ranks = zero_ranks
    params = {k: torch.from_numpy(inputs[f"zp_{k}"]) for k in ("w", "b")}
    opt = Zero1FusedAdam(axis_name="dp", num_shards=8)
    state = opt.init(params)
    n_el = sum(p.numel() for p in params.values())
    total = 8 * sum(m.numel() for m in state.mu)
    assert total >= n_el and total % 8 == 0
    assert total - n_el < 8 * len(state.mu)
    for res in ranks:
        assert bool(res["shard_roundtrip"])
    two = Zero1FusedAdam(axis_name="dp", num_shards=2, bucket_cap_mb=0.0005)
    shard0 = two.init(params).mu[0].numel()
    assert ranks[0]["shard_mu0"].shape == (shard0,)


def test_zero1_bf16_params_fp32_reduce(zero_ranks):
    """bf16 storage, fp32 grads: the params update and gather in bf16,
    the moments stay fp32 (``test_zero1.py:109``); the reference's step
    within one bf16 ulp. The replicated path sums bf16 grads in bf16,
    ZeRO-1 in fp32: the documented difference, here within one ulp too
    (the first Adam step moves each element by lr times g / |g|)."""
    inputs, ranks = zero_ranks
    opt = JZero1(lr=1e-2, axis_name="dp", num_shards=2)
    params = {"w": jnp.asarray(inputs["bf_w"]).astype(jnp.bfloat16)}
    specs = opt.state_specs(params)
    new_p, _ = jax.jit(shard_map(
        lambda p, s, g: opt.step({"w": g[0]}, s, p), mesh=_mesh(),
        in_specs=(P(), specs, P("dp")), out_specs=(P(), specs),
        check_vma=False))(params, opt.init(params),
                          jnp.asarray(inputs["bf_g"]))
    want = np.asarray(new_p["w"], np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    before = inputs["bf_w"].astype(jnp.bfloat16).astype(np.float32)
    for res in ranks:
        got = _bf16(res["bf_w"])
        assert bool(res["bf_mu_dtype32"])
        assert not np.array_equal(got, before)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.all(np.abs(_bf16(res["bf_replicated_w"]) - got) <= ulp)
    tree = {"w": torch.zeros(24, 16, dtype=torch.bfloat16)}
    assert Zero1FusedAdam(axis_name="dp", num_shards=8).comms_bytes(
        tree) * 4 == grad_sync_comms_bytes(tree, 8, "allreduce") * 3
    assert Zero1FusedAdam(axis_name="dp", num_shards=8).comms_bytes(tree) \
        == j_comms({"w": jnp.zeros((24, 16), jnp.bfloat16)}, 8, "zero1")


def _bf16(bits):
    return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()


def test_num_shards_mismatch_is_loud(zero_ranks):
    _, ranks = zero_ranks
    for res in ranks:
        assert "num_shards=4" in str(res["mismatch"])


def test_unpack_state_rejects_diverged_plan():
    params = {"w": torch.ones(37, 11), "b": torch.ones(13)}
    opt = Zero1FusedAdam(axis_name="dp", num_shards=8)
    state = opt.init(params)
    bad = state._replace(mu=state.mu + (state.mu[0],))
    with pytest.raises(ValueError, match="diverged"):
        opt.unpack_state(params, bad)


def test_layout_and_elastic_candidates_equal_reference(zero_ranks):
    inputs, _ = zero_ranks
    pparams = {k: torch.from_numpy(inputs[f"zp_{k}"]) for k in ("w", "b")}
    jparams = {k: jnp.asarray(inputs[f"zp_{k}"]) for k in ("w", "b")}
    for n in (2, 3, 8):
        kw = dict(axis_name="dp", num_shards=n, bucket_cap_mb=0.0005)
        p, j = Zero1FusedAdam(**kw), JZero1(**kw)
        assert p.state_layout(pparams) == j.state_layout(jparams)
        assert p.elastic_candidates(pparams) == j.elastic_candidates(jparams)
        assert p.comms_bytes(pparams) == j.comms_bytes(jparams)


def test_gathered_state_checkpoints_under_the_reference_schema(zero_ranks):
    """Rank 0 saves the gathered global state with the sharding specs;
    the commit marker's schema fingerprint equals the reference's for the
    same state, and a restore sliced back into shards gives each rank's
    moments and the params bit for bit."""
    inputs, ranks = zero_ranks
    opt, params, state, _ = _jax_zero1_run(inputs)
    specs = {"params": {"b": P(), "w": P()}, "opt": opt.state_specs(params)}
    want = j_state_schema_of({"params": params, "opt": state}, specs)
    for res in ranks:
        assert str(res["ckpt_fingerprint"]) == want["fingerprint"]
        assert bool(res["restored_equal"])


def test_checkpoint_manager_saves_the_given_specs(tmp_path):
    """A blocking ``CheckpointManager.save`` with ``specs`` writes the
    schema of :func:`state_schema_of` with them: the reference's
    fingerprint for the reference's global ZeRO-1 state; a spec list of
    another length fails the save."""
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.parallel.zero import Zero1AdamState

    opt, params, state, _ = _jax_zero1_run(_inputs())
    specs = {"params": {"b": P(), "w": P()}, "opt": opt.state_specs(params)}
    want = j_state_schema_of({"params": params, "opt": state}, specs)

    def t(a):
        return torch.from_numpy(np.array(a))

    tstate = {"params": {k: t(v) for k, v in params.items()},
              "opt": Zero1AdamState(count=t(state.count),
                                    mu=tuple(t(m) for m in state.mu),
                                    nu=tuple(t(v) for v in state.nu))}
    popt = Zero1FusedAdam(axis_name="dp", num_shards=2,
                          bucket_cap_mb=0.0005)
    spec = popt.state_specs(tstate["params"])
    leaf_specs = [spec.count, *spec.mu, *spec.nu, (), ()]
    manager = ckpt.CheckpointManager(str(tmp_path / "m"))
    manager.save(3, tstate, specs=leaf_specs)
    schema = ckpt.read_manifest(str(tmp_path / "m" / "step_00000003"))[
        "state_schema"]
    assert schema == ckpt.state_schema_of(tstate, leaf_specs)
    assert schema["fingerprint"] == want["fingerprint"]
    with pytest.raises(ValueError, match="the trees diverged"):
        manager.save(4, tstate, specs=leaf_specs[:-1])


def test_sharded_state_survives_preempt_crash_restart(zero_ranks):
    """Each rank's loop (``ResilientTrainLoop``, one directory a rank)
    preempted at step 4 and restarted reaches the uninterrupted run's
    params and moment shards bit for bit (``test_zero1.py:206``)."""
    _, ranks = zero_ranks
    for res in ranks:
        assert "Preempted" in str(res["preempted"])
        assert bool(res["preempt_equal"])
        assert int(res["preempt_count"]) == 7
        assert bool(res["preempt_moved"])


def test_sharded_state_survives_torn_emergency_save(zero_ranks):
    """The emergency save at the preemption is torn: the restart falls
    back to step 4, replays, and lands bit-identical
    (``test_zero1.py:238``)."""
    _, ranks = zero_ranks
    for res in ranks:
        assert bool(res["torn_preempted"])
        assert int(res["torn_resumed_from"]) == 4
        assert bool(res["torn_equal"])
