"""The port's process-group grid, microbatch calculators, RNG streams,
GradScaler, data broadcast, pipeline utilities, timers and
``opt_partition_specs`` (``apex_tpu_torch.transformer``,
``apex_tpu_torch.optimizers``) held against the JAX package's.

Rank-bound parts run in one launch of 8 gloo CPU ranks (tp 2, pp 2,
dp 2; ``tests/torch_megatron_suites.py::suite_megatron_state``); the
reference's getters are evaluated on its own mesh with its rank
overrides set to each rank's coordinates (its global-rank conversions
are host arithmetic). Host-side parts run in this process against the
reference directly. The RNG streams cannot match JAX's bits: they are
held to the reference's contract instead (differ per tp rank, equal
across dp, replayed under ``checkpoint``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import optimizers as jopt
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.amp import GradScaler as JGradScaler
from apex_tpu.transformer.pipeline_parallel import utils as jpu
from apex_tpu.transformer.tensor_parallel import utils as jtu
from apex_tpu_torch import optimizers as popt
from apex_tpu_torch.transformer import microbatches as pmb
from apex_tpu_torch.transformer import parallel_state as pps
from apex_tpu_torch.transformer import utils as putils
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.pipeline_parallel import utils as ppu
from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers
from apex_tpu_torch.transformer.tensor_parallel import random as prand
from apex_tpu_torch.transformer.tensor_parallel import utils as ptu
from torch_dist_worker import run_ranks


def _inputs():
    rng = np.random.default_rng(8)
    return {"split_1d": np.arange(12, dtype=np.float32),
            "l2_w": rng.standard_normal((8, 3, 2)).astype(np.float32),
            "emb_grad": rng.standard_normal((8, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def state_ranks(tmp_path_factory):
    inp = _inputs()
    return inp, run_ranks("megatron_state", 8,
                          tmp_path_factory.mktemp("ps"), inp, timeout=300)


def _coords(rank):
    return {"pp": rank // 4, "dp": (rank // 2) % 2, "cp": 0, "tp": rank % 2}


@pytest.fixture()
def ref_grid():
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(2, 2)
    yield jps
    jps.destroy_model_parallel()


def _reference_at(ps, rank):
    """The reference's rank getters and global-rank conversions with its
    overrides set to ``rank``'s coordinates."""
    c = _coords(rank)
    ps._OVERRIDES.update(tp_rank=c["tp"], pp_rank=c["pp"],
                         dp_rank=c["dp"], cp_rank=c["cp"])
    out = {
        "ranks": [ps.get_tensor_model_parallel_rank(),
                  ps.get_pipeline_model_parallel_rank(),
                  ps.get_data_parallel_rank(),
                  ps.get_context_parallel_rank()],
        "global": [ps._flat_rank(), ps.get_tensor_model_parallel_src_rank(),
                   ps.get_data_parallel_src_rank(),
                   ps.get_pipeline_model_parallel_first_rank(),
                   ps.get_pipeline_model_parallel_last_rank(),
                   ps.get_pipeline_model_parallel_next_rank(),
                   ps.get_pipeline_model_parallel_prev_rank()],
        "stage_flags": [bool(ps.is_pipeline_first_stage()),
                        bool(ps.is_pipeline_last_stage()),
                        bool(ps.is_rank_in_embedding_group()),
                        bool(ps.is_rank_in_position_embedding_group())],
    }
    ps._OVERRIDES.clear()
    return out


def test_grid_sizes_and_groups(state_ranks, ref_grid):
    _, ranks = state_ranks
    mesh = ref_grid.get_mesh()
    for out in ranks:
        np.testing.assert_array_equal(
            out["mesh"], [mesh.shape[a] for a in ("pp", "dp", "cp", "tp")])
        np.testing.assert_array_equal(out["sizes"], [
            ref_grid.get_tensor_model_parallel_world_size(),
            ref_grid.get_pipeline_model_parallel_world_size(),
            ref_grid.get_data_parallel_world_size(),
            ref_grid.get_context_parallel_world_size()])
        assert list(out["groups"]) == [
            ref_grid.get_tensor_model_parallel_group(),
            ref_grid.get_pipeline_model_parallel_group(),
            ref_grid.get_data_parallel_group(),
            ref_grid.get_context_parallel_group(),
            ref_grid.get_embedding_group(),
            "+".join(ref_grid.get_model_parallel_group())]
        assert "not divisible" in str(out["indivisible"])
        np.testing.assert_array_equal(out["before_init"], [False, True, 0])


@pytest.mark.parametrize("rank", range(8))
def test_rank_getters_match_reference_layout(state_ranks, ref_grid, rank):
    """Each rank's coordinates, global-rank conversions (src ranks,
    pipeline neighbours) and stage flags are the reference's for the
    device at the same place in its ('pp', 'dp', 'cp', 'tp') mesh."""
    _, ranks = state_ranks
    want = _reference_at(ref_grid, rank)
    out = ranks[rank]
    np.testing.assert_array_equal(out["ranks"], want["ranks"])
    np.testing.assert_array_equal(out["rank_info"], want["ranks"][:3])
    np.testing.assert_array_equal(out["global"], want["global"])
    np.testing.assert_array_equal(out["stage_flags"], want["stage_flags"])


def test_group_members_follow_reference_order(state_ranks, ref_grid):
    """The ranks of each group are the devices along the axis of the
    reference's mesh (tp fastest, then dp, pp outermost); "data" is the
    dp group."""
    _, ranks = state_ranks
    devices = np.arange(8).reshape(2, 2, 1, 2)  # pp, dp, cp, tp
    for rank, out in enumerate(ranks):
        c = _coords(rank)
        want = [devices[c["pp"], c["dp"], 0, :],
                devices[:, c["dp"], 0, c["tp"]],
                devices[c["pp"], :, 0, c["tp"]]]
        np.testing.assert_array_equal(out["members"], np.stack(want))
        np.testing.assert_array_equal(out["data_members"], want[2])
        assert int(out["dp_after_destroy"]) == 8


def test_virtual_pipeline_and_split_rank(state_ranks):
    _, ranks = state_ranks
    for rank, out in enumerate(ranks):
        pp = _coords(rank)["pp"]
        # virtual rank 0 of 2: the last stage is not last yet
        np.testing.assert_array_equal(out["virtual"], [
            2, 0, pp == 0, False, 1, pp < 1, pp >= 1, pp == 0])
        np.testing.assert_array_equal(out["virtual_1"], [False, pp == 1,
                                                         pp == 0])
        np.testing.assert_array_equal(out["overrides"], [1, 4])


def test_split_rank_predicates_match_reference():
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1, 4, pipeline_model_parallel_split_rank_=2)
    for r in range(4):
        for fn in ("is_pipeline_stage_before_split",
                   "is_pipeline_stage_after_split"):
            pps._OVERRIDES["pp_world"] = 4
            pps._PIPELINE_SPLIT_RANK = 2
            try:
                assert getattr(pps, fn)(r) == bool(getattr(jps, fn)(r))
            finally:
                pps._OVERRIDES.clear()
                pps._PIPELINE_SPLIT_RANK = None
    jps.destroy_model_parallel()


def test_broadcast_and_1d_split(state_ranks):
    inp, ranks = state_ranks
    for rank, out in enumerate(ranks):
        src = rank - rank % 2  # tp-rank 0 of this rank's group
        np.testing.assert_array_equal(out["bcast_text"], np.full((2, 3), src))
        np.testing.assert_array_equal(out["bcast_mask"], np.full(4, 10 + src))
        assert "expected torch.float32" in str(out["bcast_dtype_error"])
        np.testing.assert_array_equal(
            out["split_1d"], inp["split_1d"][6 * (rank % 2):
                                             6 * (rank % 2) + 6])
        np.testing.assert_array_equal(out["gather_1d"], inp["split_1d"])


def test_grad_scaler_overflow_vote(state_ranks):
    """Rank 5 alone overflows: the vote over tp then pp reaches its whole
    model-parallel plane (the ranks of its dp index: 0, 1, 4, 5), which
    skip and back off by backoff_factor; the other dp replica does not.
    Voting over tp only: ranks 4 and 5."""
    _, ranks = state_ranks
    plane = (0, 1, 4, 5)
    for rank, out in enumerate(ranks):
        assert bool(out["scaler_overflow"]) == (rank in plane)
        assert float(out["scaler_next"]) == (2.0 if rank in plane else 4.0)
        assert bool(out["scaler_tp_only"]) == (rank in (4, 5))


def test_grad_scaler_host_behaviour_matches_reference():
    """Asymmetric backoff, growth after the interval, unscale: the
    reference's scaler state sequence."""
    for kw in (dict(init_scale=2.0 ** 10, backoff_factor=0.25),
               dict(init_scale=2.0 ** 8, growth_interval=3)):
        ref = JGradScaler(model_parallel_axes=(), **kw)
        port = GradScaler(model_parallel_axes=(), **kw)
        rs, ps_ = ref.init(), port.init()
        for ovf in (False, True, False, False, False):
            rs = ref.update(rs, jnp.asarray(ovf))
            ps_ = port.update(ps_, torch.tensor(ovf))
            assert float(ps_.loss_scale) == float(rs.loss_scale)
    g = np.array([2.0, 4.0, np.inf], np.float32)
    ref = JGradScaler(init_scale=2.0, model_parallel_axes=())
    port = GradScaler(init_scale=2.0, model_parallel_axes=())
    ru, rov = ref.unscale({"g": jnp.asarray(g)}, ref.init())
    pu_, pov = port.unscale({"g": torch.from_numpy(g)}, port.init())
    np.testing.assert_array_equal(pu_["g"].numpy(), np.asarray(ru["g"]))
    assert bool(pov) == bool(rov)


def test_rng_streams(state_ranks):
    """The model-parallel stream differs per tp rank and is equal over
    dp and pp; the default stream and the base generator are the same
    everywhere; tp_rank_key leaves its base generator where it was."""
    _, ranks = state_ranks
    for rank, out in enumerate(ranks):
        twin = rank ^ 1  # same dp and pp, the other tp rank
        assert not np.array_equal(out["rng_tp"], ranks[twin]["rng_tp"])
        assert not np.array_equal(out["rng_key"], ranks[twin]["rng_key"])
        same_tp = [r for r in range(8) if r % 2 == rank % 2]
        for r in same_tp:
            np.testing.assert_array_equal(out["rng_tp"], ranks[r]["rng_tp"])
            np.testing.assert_array_equal(out["rng_key"], ranks[r]["rng_key"])
        np.testing.assert_array_equal(out["rng_default"],
                                      ranks[0]["rng_default"])
        want = torch.rand(2, generator=torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(out["rng_base_after"], want.numpy())


def test_dp_loss_average_l2_norm_and_embedding_allreduce(state_ranks):
    inp, ranks = state_ranks
    for rank, out in enumerate(ranks):
        dp_peers = [r for r in range(8)
                    if r // 4 == rank // 4 and r % 2 == rank % 2]
        np.testing.assert_allclose(out["avg_losses"],
                                   [np.mean(dp_peers),
                                    2 * np.mean(dp_peers)], rtol=1e-6)
        # squares summed over this rank's tp and pp groups
        peers = [r for r in range(8) if (r // 2) % 2 == (rank // 2) % 2]
        want = np.sqrt(sum(np.sum(inp["l2_w"][r].astype(np.float64) ** 2)
                           for r in peers))
        np.testing.assert_allclose(out["l2"], want, rtol=1e-5)
        pp_peers = [r for r in range(8) if r % 4 == rank % 4]
        np.testing.assert_allclose(
            out["emb_allreduce"], sum(inp["emb_grad"][r] for r in pp_peers),
            rtol=1e-6)


# ------------------------------------------------------------ host side


def test_divide_and_ensure():
    assert putils.divide(12, 4) == jtu.divide(12, 4) == 3
    for mod in (putils, jtu):
        with pytest.raises(ValueError):
            mod.divide(10, 4)


@pytest.mark.parametrize("args", [
    (0, None, 64, 4, 2), (1, [16, 16, 1000], 64, 4, 2),
    (0, [32, 8, 96], 128, 8, 2), (0, [64, 8, 100], 64, 4, 2)])
def test_microbatch_calculators_match_reference(args):
    """Constant and ramp-up calculators: the number of microbatches and
    the global batch after each consumed-samples update."""
    ref = jmb.build_num_microbatches_calculator(*args)
    port = pmb.build_num_microbatches_calculator(*args)
    assert type(port).__name__ == type(ref).__name__
    for consumed in (0, 10, 40, 64, 100, 400, 2000):
        ref.update(consumed, False)
        port.update(consumed, False)
        assert port.get() == ref.get()
        assert port.get_current_global_batch_size() == \
            ref.get_current_global_batch_size()


def test_microbatch_calculator_errors_and_globals():
    with pytest.raises(ValueError):
        pmb.build_num_microbatches_calculator(0, [16, 8], 64, 4, 2)
    calc = pmb.build_num_microbatches_calculator(0, [12, 4, 100], 64, 4, 2)
    with pytest.raises(ValueError):
        calc.update(0, True)  # 12 sequences do not split into 4 x 2
    ppu.destroy_microbatch_calculator()
    ppu.setup_microbatch_calculator(0, None, 64, 4, 2)
    try:
        assert ppu.get_num_microbatches() == 8
        assert ppu.get_micro_batch_size() == 4
        assert ppu.get_current_global_batch_size() == 64
        with pytest.raises(RuntimeError):
            ppu.setup_microbatch_calculator(0, None, 64, 4, 2)
        ppu._reconfigure_microbatch_calculator(0, None, 32, 4, 2)
        assert ppu.get_num_microbatches() == 4
    finally:
        ppu.destroy_microbatch_calculator()


def test_split_batch_and_ltor_masks_match_reference():
    data = np.array([[5, 1, 7, 2, 1, 3], [1, 4, 4, 1, 9, 8]])
    batch = {"text": data, "mask": data * 2}
    for mbs in (1, 2):
        got = ppu.split_batch_into_microbatches(
            {k: torch.from_numpy(v) for k, v in batch.items()}, mbs)
        want = jpu.split_batch_into_microbatches(batch, mbs)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            ppu.get_kth_microbatch(got, 0)["text"].numpy(),
            np.asarray(jpu.get_kth_microbatch(want, 0)["text"]))
    for kw in (dict(), dict(eod_token=1, eod_mask_loss=True),
               dict(eod_token=1, reset_position_ids=True),
               dict(eod_token=1, reset_attention_mask=True,
                    reset_position_ids=True, eod_mask_loss=True)):
        got = ppu.get_ltor_masks_and_position_ids(torch.from_numpy(data),
                                                  **kw)
        want = jpu.get_ltor_masks_and_position_ids(jnp.asarray(data), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split_tensor_and_vocab_utility():
    x = np.arange(12.0, dtype=np.float32).reshape(2, 6)
    got = ptu.split_tensor_along_last_dim(torch.from_numpy(x), 3)
    want = jtu.split_tensor_along_last_dim(jnp.asarray(x), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(c.is_contiguous() for c in ptu.split_tensor_along_last_dim(
        torch.from_numpy(x), 3, contiguous_split_chunks=True))
    for args in ((12, 1, 4), (128, 3, 4)):
        assert ptu.VocabUtility.vocab_range_from_global_vocab_size(*args) \
            == jtu.VocabUtility.vocab_range_from_global_vocab_size(*args)
    assert ptu.VocabUtility.vocab_range_from_per_partition_vocab_size(
        5, 2, 4) == (10, 15)


def test_rng_tracker_fork_advances_and_restores():
    tr = prand.RNGStatesTracker()
    tr.add("default", 0)
    with tr.fork("default") as g1:
        a = torch.rand(3, generator=g1)
    with tr.fork("default") as g2:
        b = torch.rand(3, generator=g2)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        tr.add("default", 1)
    with pytest.raises(ValueError):
        tr.add("other", 0)  # duplicate seed
    with pytest.raises(KeyError):
        with tr.fork("missing"):
            pass
    tr2 = prand.RNGStatesTracker()
    tr2.set_states(tr.get_states())
    with tr.fork("default") as x, tr2.fork("default") as y:
        assert torch.equal(torch.rand(4, generator=x),
                           torch.rand(4, generator=y))
    with pytest.raises(TypeError):
        tr2.set_states([1])
    prand.model_parallel_rng_seed(123)
    tr = prand.get_rng_tracker()
    with tr.fork("default") as d, tr.fork("model-parallel-rng") as m:
        assert not torch.equal(torch.rand(4, generator=d),
                               torch.rand(4, generator=m))
    assert prand.get_cuda_rng_tracker() is prand.get_rng_tracker()
    assert prand.model_parallel_cuda_manual_seed is \
        prand.model_parallel_rng_seed


def test_checkpoint_matches_plain_and_replays_generators():
    """``checkpoint``'s gradient equals the plain one, also for a
    function that draws dropout from a generator argument (the recompute
    draws the same mask)."""
    x = torch.randn(8, dtype=torch.float64)

    def f(x):
        return torch.sum(torch.tanh(x) ** 2)

    a = x.clone().requires_grad_()
    prand.checkpoint(f, a).backward()
    b = x.clone().requires_grad_()
    f(b).backward()
    torch.testing.assert_close(a.grad, b.grad)

    def drop(x, gen):
        keep = torch.rand(x.shape, generator=gen, dtype=x.dtype) > 0.5
        return torch.sum(torch.where(keep, x * 2.0, 0.0) ** 2)

    c = x.clone().requires_grad_()
    prand.checkpoint(drop, c, torch.Generator().manual_seed(3)).backward()
    d = x.clone().requires_grad_()
    drop(d, torch.Generator().manual_seed(3)).backward()
    torch.testing.assert_close(c.grad, d.grad)


def test_timers_log_write_and_registry():
    from apex_tpu_torch.observability import MetricRegistry

    reg = MetricRegistry()
    timers = Timers(registry=reg)
    timers("fwd").start()
    with pytest.raises(RuntimeError):
        timers("fwd").start()
    timers("fwd").stop()
    with pytest.raises(RuntimeError):
        timers("fwd").stop()
    assert timers("fwd").elapsed(reset=False) >= 0.0
    lines = []
    timers.log(["fwd", "never"], printer=lines.append)
    assert lines and lines[0].startswith("time (ms) | fwd:")
    assert "never" not in lines[0]
    assert timers("fwd").elapsed_ == 0.0  # log reset it

    class Writer:
        def __init__(self):
            self.rows = []

        def add_scalar(self, tag, value, step):
            self.rows.append((tag, step))

    w = Writer()
    timers("bwd").start()
    timers("bwd").stop()
    timers.write(["bwd", "never"], w, 7)
    assert w.rows == [("bwd-time", 7)]
    names = {r["name"] for r in reg.to_records()}
    assert {"pp_phase/fwd", "pp_phase/bwd"} <= names


def test_opt_partition_specs_match_reference():
    """Tree-mode moments take the params' specs, the counter and a flat
    state's slabs replicate: the reference's structure, its
    ``PartitionSpec`` entries as tuples."""
    params = {"w": np.ones((4, 6), np.float32), "b": np.ones(6, np.float32)}
    pspecs = {"w": (None, "tp"), "b": ("tp",)}
    from jax.sharding import PartitionSpec as P

    for flat in (False, True):
        ref = jopt.opt_partition_specs(
            jopt.fused_adam(flat=flat), jax.tree_util.tree_map(
                jnp.asarray, params), {k: P(*v) for k, v in pspecs.items()})
        got = popt.opt_partition_specs(
            popt.fused_adam(flat=flat),
            {k: torch.from_numpy(v) for k, v in params.items()}, pspecs)
        assert type(got).__name__ == type(ref).__name__
        assert got.count == tuple(ref.count)
        want_mu = jax.tree_util.tree_map(
            tuple, ref.mu, is_leaf=lambda s: isinstance(s, P))
        assert got.mu == want_mu and got.nu == want_mu


def test_rank_prints_and_model_helpers(capsys):
    """The rank-0 and last-rank prints outside a process group (one
    rank), report_memory on the CPU, print_params_min_max_norm's lines,
    and the reference's listify/unwrap/param_is_not_shared helpers."""
    ppu.print_rank_0("hello")
    ppu.print_rank_last("bye")
    assert ppu.is_last_rank()
    line = ppu.report_memory("x")
    assert line == "[x] memory on cpu: not tracked" or "allocated" in line
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": -torch.ones(3)}
    ppu.print_params_min_max_norm(params, 7)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["hello", "bye"]
    rows = [x for x in out if x.startswith("iteration, rank")]
    assert len(rows) == 2 and rows[1].split()[-1] == "w"
    assert "0.000000e+00 5.000000e+00" in rows[1]

    class Wrap:
        def __init__(self, module):
            self.module = module

    inner = object()
    assert ppu.unwrap_model(Wrap(Wrap(inner))) is inner
    assert ppu.unwrap_model([Wrap(inner)]) == [inner]
    assert ppu.listify_model(inner) == [inner] == jpu.listify_model(inner)
    assert ppu.param_is_not_shared(params["w"])
