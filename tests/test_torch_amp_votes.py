"""amp's votes across ranks (``apex_tpu_torch.amp.scaler``): the overflow
flag of ``scaled_update(overflow_reduce_axes=...)`` summed over the
group, so that every rank skips a step any rank overflowed, and the fp8
amax observations of ``Fp8DelayedScaler.update(reduce_axes=...)``
max-reduced, so that every rank writes the same ring column. 2 gloo
ranks on the CPU against the JAX package's under ``shard_map`` over 2
simulated devices (``apex_tpu/amp/scaler.py:556-623``), from the same
per-rank grads and observations.

Tolerances: the overflow decisions, loss scales, step counts and fp8
rings are exact; params within the flat Adam tolerance of
``tests/test_torch_fused_adam.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.amp.scaler import Fp8DelayedScaler as JFp8
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from torch_dist_worker import run_ranks

RTOL, ATOL = 4e-6, 2e-7
STEPS = 3


def _inputs():
    rng = np.random.default_rng(11)
    out = {"amp_w": rng.standard_normal(8).astype(np.float32)}
    for step in range(STEPS):
        g = (rng.standard_normal((2, 8)) * 2.0 ** 10).astype(np.float32)
        if step == 1:
            g[1, 3] = np.inf  # only rank 1 overflows
        out[f"amp_g{step}"] = g
        out[f"fp8_fwd{step}"] = np.abs(rng.standard_normal((2, 4))).astype(
            np.float32) * (step + 1)
        out[f"fp8_grad{step}"] = np.abs(rng.standard_normal((2, 2))).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def amp_ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("amp", 2, tmp_path_factory.mktemp("amp"),
                             inputs)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def test_overflow_vote_skips_the_step_on_every_rank(amp_ranks):
    """Rank 1's inf at step 1 skips that step on both ranks: the updates
    are zeros, the Adam state stays, the scale halves everywhere."""
    inputs, ranks = amp_ranks
    tx = jax_fused_adam(lr=1e-2, flat=True)
    sc = jamp.LossScaler("dynamic", init_scale=2.0 ** 10)
    w0 = jnp.asarray(inputs["amp_w"])

    def stack(t):
        return jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), t)

    def step_fn(p, os, ss, g):
        un = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)  # noqa
        upd, os2, ss2, ovf = jamp.scaled_update(
            tx, sc, {"w": g[0]}, un(os), un(p), un(ss),
            overflow_reduce_axes=("dp",))
        newp = jax.tree_util.tree_map(jnp.add, un(p), upd)
        st = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa
        return st(newp), st(os2), st(ss2), ovf[None]

    fn = jax.jit(shard_map(step_fn, mesh=_mesh(), in_specs=P("dp"),
                           out_specs=P("dp"), check_vma=False))
    p, os, ss = stack({"w": w0}), stack(tx.init({"w": w0})), stack(sc.init())
    for step in range(STEPS):
        p, os, ss, ovf = fn(p, os, ss, jnp.asarray(inputs[f"amp_g{step}"]))
        for r, res in enumerate(ranks):
            assert bool(res[f"amp_ovf{step}"]) == bool(ovf[r]) == (step == 1)
            assert float(res[f"amp_scale{step}"]) == float(ss.loss_scale[r])
            np.testing.assert_allclose(res[f"amp_w{step}"],
                                       np.asarray(p["w"][r]), rtol=RTOL,
                                       atol=ATOL)
    for r, res in enumerate(ranks):
        assert int(res["amp_count"]) == int(os.count[r]) == STEPS - 1
        np.testing.assert_array_equal(res["amp_w1"], res["amp_w0"])
    assert float(ranks[0]["amp_scale1"]) == 2.0 ** 9


def test_fp8_amax_vote_writes_the_same_column_on_every_rank(amp_ranks):
    """Each ring's columns hold the max over the ranks of each step's
    observations, on both ranks, as the reference's pmax writes them."""
    inputs, ranks = amp_ranks
    fp8 = JFp8(["s", "t"], history=4)

    class Observed:
        def __init__(self, fwd, grad):
            self.fwd, self.grad = fwd, grad

        def fwd_amax(self):
            return self.fwd

        def grad_amax(self):
            return self.grad

    def upd(state, fwd, grad):
        return fp8.update(state, Observed(fwd[0], grad[0]),
                          reduce_axes=("dp",))

    fn = jax.jit(shard_map(upd, mesh=_mesh(),
                           in_specs=(P(), P("dp"), P("dp")), out_specs=P(),
                           check_vma=False))
    state = fp8.init()
    for step in range(STEPS):
        state = fn(state, jnp.asarray(inputs[f"fp8_fwd{step}"]),
                   jnp.asarray(inputs[f"fp8_grad{step}"]))
    d = fp8.state_dict(state)
    fwd_scales, grad_scales = fp8.scales(state)
    for res in ranks:
        np.testing.assert_array_equal(res["fp8_fwd_ring"],
                                      np.array(d["fwd"]["ring"], np.float32))
        np.testing.assert_array_equal(res["fp8_grad_ring"],
                                      np.array(d["grad"]["ring"],
                                               np.float32))
        np.testing.assert_array_equal(res["fp8_scales_fwd"],
                                      np.asarray(fwd_scales))
        np.testing.assert_array_equal(res["fp8_scales_grad"],
                                      np.asarray(grad_scales))
    newest = np.array(d["fwd"]["ring"], np.float32)
    assert newest.max() == inputs[f"fp8_fwd{STEPS - 1}"].max()
