"""The port's pipeline schedules and stage-to-stage shifts
(``apex_tpu_torch.transformer.pipeline_parallel``) held against the JAX
package's.

One launch of 4 gloo CPU ranks, one a stage (``tests/
torch_megatron_suites.py::suite_megatron_pp``); the reference runs its
collective schedules under ``shard_map`` over a 4-stage ``'pp'`` mesh on
the conftest's simulated devices, with the cases and the stage function
of ``tests/run_transformer/test_pipeline_parallel.py``. Host-side parts
(no pipelining, the weight-decay mask, the interleaved tick count) run
in this process. Tolerances: outputs and losses 1e-5 relative, gradients
1e-5 of each array's largest value (fp32); shifts move values exactly.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer.pipeline_parallel import p2p as jp2p
from apex_tpu.transformer.pipeline_parallel import schedules as jS
from apex_tpu_torch.transformer.pipeline_parallel import schedules as S
from torch_dist_worker import run_ranks

PP, DIM, MB, M = 4, 6, 3, 4
TOL = 1e-5


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _loss_fn(o, t):
    return jnp.mean((o - t) ** 2)


def _mesh():
    return Mesh(np.array(jax.devices()[:PP]), ("pp",))


def _inputs():
    rng = np.random.default_rng(21)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = {"pp_w": f32(PP, DIM, DIM) / np.sqrt(DIM),
           "pp_b": 0.01 * f32(PP, DIM), "pp_x": f32(M, MB, DIM),
           "pp_tgt": f32(M, MB, DIM),
           "il_w": f32(2 * PP, DIM, DIM) / np.sqrt(DIM),
           "il_b": 0.01 * f32(2 * PP, DIM), "p2p_x": f32(PP, 5),
           "p2p_ct": f32(PP, 5)}
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def pp_ranks(tmp_path_factory):
    inp = _inputs()
    return inp, run_ranks("megatron_pp", PP, tmp_path_factory.mktemp("pp"),
                          inp, timeout=300)


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _shard_pp(fn, *args, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(), in_specs=in_specs,
                             out_specs=out_specs))(*args)


def test_pipelined_forward_matches_reference(pp_ranks):
    inp, ranks = pp_ranks
    params = {"w": inp["pp_w"], "b": inp["pp_b"]}

    def fn(params, x):
        local = jax.tree_util.tree_map(lambda p: p[0], params)
        outs = jS.pipelined_forward(_stage_fn, local, x)
        r = jax.lax.axis_index("pp")
        return jax.lax.psum(jnp.where(r == PP - 1, outs, 0.0), "pp")

    want = _shard_pp(fn, params, inp["pp_x"], in_specs=(P("pp"), P()),
                     out_specs=P())
    np.testing.assert_allclose(ranks[-1]["fwd"], want, rtol=TOL, atol=1e-6)
    for out in ranks[:-1]:  # only the last stage's buffer is meaningful
        np.testing.assert_array_equal(out["fwd"], 0.0)


def _reference_fwd_bwd(inp):
    params = {"w": inp["pp_w"], "b": inp["pp_b"]}

    def fn(params):
        local = jax.tree_util.tree_map(lambda p: p[0], params)
        loss, grads = jS.forward_backward_pipelining_without_interleaving(
            _stage_fn, _loss_fn, local, inp["pp_x"], inp["pp_tgt"])
        return loss, jax.tree_util.tree_map(lambda g: g[None], grads)

    return _shard_pp(fn, params, in_specs=(P("pp"),),
                     out_specs=(P(), P("pp")))


def test_fwd_bwd_pipelining_matches_reference(pp_ranks):
    """1F1B: every stage's loss and the grads of its own params, with and
    without recompute."""
    inp, ranks = pp_ranks
    loss, grads = _reference_fwd_bwd(inp)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["fb_loss"], float(loss), rtol=TOL)
        _close(out["fb_gw"], np.asarray(grads["w"])[r], ("w", r))
        _close(out["fb_gb"], np.asarray(grads["b"])[r], ("b", r))
        _close(out["fb_noremat_gw"], np.asarray(grads["w"])[r],
               ("w no remat", r))


def test_fwd_bwd_forward_only(pp_ranks):
    inp, ranks = pp_ranks
    loss, _ = _reference_fwd_bwd(inp)
    for out in ranks:
        assert bool(out["fo_none"])
        np.testing.assert_allclose(out["fo_loss"], float(loss), rtol=TOL)


def _reference_interleaved(inp, m_count):
    chunks = {"w": inp["il_w"].reshape(2, PP, DIM, DIM).transpose(1, 0, 2, 3),
              "b": inp["il_b"].reshape(2, PP, DIM).transpose(1, 0, 2)}

    def fn(chunks):
        local = jax.tree_util.tree_map(lambda p: p[0], chunks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loss, grads = jS.forward_backward_pipelining_with_interleaving(
                _stage_fn, _loss_fn, local, inp["pp_x"][:m_count],
                inp["pp_tgt"][:m_count])
        return loss, jax.tree_util.tree_map(lambda g: g[None], grads)

    return _shard_pp(fn, chunks, in_specs=(P("pp"),),
                     out_specs=(P(), P("pp")))


def test_interleaved_matches_reference_2x_chunks(pp_ranks):
    """V = 2 chunks x P = 4 stages: rank r holds virtual stages r and
    r + 4; the loss and each chunk's grads."""
    inp, ranks = pp_ranks
    loss, grads = _reference_interleaved(inp, M)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["il_loss"], float(loss), rtol=TOL)
        _close(out["il_gw"], np.asarray(grads["w"])[r], ("il w", r))
        _close(out["il_gb"], np.asarray(grads["b"])[r], ("il b", r))


def test_interleaved_falls_back_to_chained_when_m_not_divisible(pp_ranks):
    inp, ranks = pp_ranks
    loss, grads = _reference_interleaved(inp, 3)
    for r, out in enumerate(ranks):
        assert bool(out["chain_warned"])
        np.testing.assert_allclose(out["chain_loss"], float(loss), rtol=TOL)
        _close(out["chain_gw"], np.asarray(grads["w"])[r], ("chain w", r))
        assert "whole microbatch groups" in str(out["strict_error"])


def test_get_forward_backward_func(pp_ranks):
    _, ranks = pp_ranks
    assert list(ranks[0]["fb_func"]) == [
        "forward_backward_pipelining_without_interleaving",
        "_forward_backward_pipelining_with_interleaving",
        "forward_backward_no_pipelining"]


@pytest.mark.parametrize("name", [
    "fwd", "bwd", "cyc", "cyc_back", "send_forward", "recv_forward",
    "send_backward", "recv_backward", "send_forward_recv_backward",
    "send_backward_recv_forward",
    "send_forward_backward_recv_forward_backward", "grad"])
def test_p2p_forms_match_reference(pp_ranks, name):
    """Every send/recv form (edge ranks receive zeros), the cyclic shifts,
    and the shift's gradient (the -1 shift), against ``ppermute``."""
    inp, ranks = pp_ranks
    fns = {
        "fwd": lambda v: jp2p.send_forward_recv_forward(v),
        "bwd": lambda v: jp2p.send_backward_recv_backward(v),
        "cyc": lambda v: jp2p._shift_cyclic(v, +1),
        "cyc_back": lambda v: jp2p._shift_cyclic(v, -2),
        "send_forward": jp2p.send_forward,
        "recv_forward": jp2p.recv_forward,
        "send_backward": jp2p.send_backward,
        "recv_backward": jp2p.recv_backward,
        "send_forward_recv_backward":
            lambda v: jnp.stack(jp2p.send_forward_recv_backward(v, v * 10)),
        "send_backward_recv_forward":
            lambda v: jnp.stack(jp2p.send_backward_recv_forward(v, v * 10)),
        "send_forward_backward_recv_forward_backward":
            lambda v: jnp.stack(
                jp2p.send_forward_backward_recv_forward_backward(v, v * 10)),
    }
    if name == "grad":
        def body(v, ct):
            _, vjp = jax.vjp(lambda a: jp2p._shift(a, +1), v[0])
            return vjp(ct[0])[0][None]

        want = _shard_pp(body, inp["p2p_x"], inp["p2p_ct"],
                         in_specs=(P("pp"), P("pp")), out_specs=P("pp"))
        key = "p2p_grad"
    else:
        want = _shard_pp(lambda v: fns[name](v[0])[None], inp["p2p_x"],
                         in_specs=(P("pp"),), out_specs=P("pp"))
        key = f"p2p_{name}"
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key], np.asarray(want)[r],
                                      err_msg=f"{name} rank {r}")


def test_no_pipelining_grad_accumulation():
    """Microbatched accumulation: the mean loss and the grads scaled by
    1 / M (and by grad_scale / M) equal the reference's."""
    inp = _inputs()
    w = inp["pp_w"][0]
    mbs = (inp["pp_x"], inp["pp_tgt"])

    def jloss(p, mb):
        return jnp.mean((jnp.tanh(mb[0] @ p["w"]) - mb[1]) ** 2)

    def tloss(p, mb):
        return torch.mean((torch.tanh(mb[0] @ p["w"]) - mb[1]) ** 2)

    for scale in (None, 4.0):
        ref_loss, ref_g = jS.forward_backward_no_pipelining(
            jloss, {"w": jnp.asarray(w)},
            tuple(jnp.asarray(a) for a in mbs), grad_scale=scale)
        loss, g = S.forward_backward_no_pipelining(
            tloss, {"w": torch.from_numpy(w)},
            tuple(torch.from_numpy(a) for a in mbs), grad_scale=scale)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
        _close(g["w"].numpy(), ref_g["w"], ("no pipelining", scale))
    floss, none = S.forward_backward_no_pipelining(
        tloss, {"w": torch.from_numpy(w)},
        tuple(torch.from_numpy(a) for a in mbs), forward_only=True)
    assert none is None
    np.testing.assert_allclose(float(floss), float(ref_loss), rtol=TOL)


def test_weight_decay_mask_and_interleaved_ticks():
    params = {"w": torch.zeros(2, 3), "b": torch.zeros(3),
              "layers": {"k": torch.zeros(2, 2, 2), "n": torch.zeros(4)}}
    jparams = {"w": jnp.zeros((2, 3)), "b": jnp.zeros(3),
               "layers": {"k": jnp.zeros((2, 2, 2)), "n": jnp.zeros(4)}}
    assert S.get_params_for_weight_decay_optimization(params) == \
        jS.get_params_for_weight_decay_optimization(jparams)
    for m, p, v in ((8, 4, 2), (4, 4, 3), (6, 3, 1)):
        assert S.interleaved_num_steps(m, p, v) == \
            jS.interleaved_num_steps(m, p, v)
        assert S.interleaved_num_steps(m, p, v) <= v * (m + p - 1)
