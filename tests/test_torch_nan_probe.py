"""The port's NaN/Inf provenance probe (``apex_tpu_torch.observability.
numerics.nan_probe``) and its place in ``ResilientTrainLoop``.

Held against the JAX package where the reference runs under jax 0.9:
``probe_tree`` gives the reference's dict on the same numpy trees, and
``step_provenance`` names the reference's ``output_paths`` on a tiny
GPT-2 params-and-grads tree with a NaN planted in one grad leaf (the
reference's jaxpr replay does not run under jax 0.9, so it returns its
paths-only report; the port replays). The reference's ``probe_fn`` does
not run there either, so the port's replay is held on cases whose first
non-finite op is known by construction: an exp overflow, 0/0, the log of
a negative, a NaN input named by its path, a finite function, a
``torch.autograd.Function`` backward and a hand-written kernel's launch
reported through ``kernel_config.note_launch``. The loop reports a
provenance for a non-finite step and ends bit for bit where it ends with
the probe off.
"""

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt2 as jgpt2
from apex_tpu.observability.numerics import nan_probe as jprobe
from apex_tpu_torch.models import gpt2 as pgpt2
from apex_tpu_torch.observability import MetricRegistry
from apex_tpu_torch.observability.numerics import nan_probe as probe
from apex_tpu_torch.ops import kernel_config
from apex_tpu_torch.resilience import FaultPlan, ResilientTrainLoop


def _numpy_trees():
    rng = np.random.default_rng(0)
    clean = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32),
                   "d": np.arange(3, dtype=np.int32)}}
    bad = {"a": clean["a"].copy(), "b": {"c": clean["b"]["c"].copy(),
                                         "d": clean["b"]["d"]},
           "e": [np.ones(2, np.float32), np.full(2, np.inf, np.float32)]}
    bad["a"][1, 2] = np.nan
    return clean, bad


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("which", ["clean", "bad"])
def test_probe_tree_equals_the_reference(which):
    tree = dict(zip(("clean", "bad"), _numpy_trees()))[which]
    want = jprobe.probe_tree(jax.tree_util.tree_map(jax.numpy.asarray,
                                                    tree)).as_dict()
    assert probe.probe_tree(_torch_tree(tree)).as_dict() == want


def test_step_provenance_names_the_references_paths():
    """A tiny GPT-2 params tree and its grads with a NaN planted in one
    grad leaf: the reference's replay fails under jax 0.9 and it returns
    its paths-only report; the port replays the step (inherited at the
    first op that reads the poisoned grad) with the same output paths."""
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), jgpt2.tiny())
    host = jax.tree_util.tree_map(np.asarray, jparams)
    grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 1e-3), host)
    grads["layers"]["wfc"] = grads["layers"]["wfc"].copy()
    grads["layers"]["wfc"][0, 1, 2] = np.nan
    bad = {"params": host, "grads": grads}
    prev = {"params": host,
            "grads": jax.tree_util.tree_map(np.zeros_like, grads)}

    def jstep(state, step):
        del step
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g,
                                      state["params"], state["grads"])

    want = jprobe.step_provenance(jstep, prev, bad, 1)
    assert "replay unavailable" in want.message

    pbad = {"params": pgpt2.params_from_numpy(host, device="cpu"),
            "grads": pgpt2.params_from_numpy(grads, device="cpu")}

    def pstep(state, step):
        del step
        out = {}
        for k, p in state["params"].items():
            g = state["grads"][k]
            out[k] = ({kk: pp - 0.1 * g[kk] for kk, pp in p.items()}
                      if isinstance(p, dict) else p - 0.1 * g)
        return out

    got = probe.step_provenance(pstep, None, pbad, 1)
    assert got.output_paths == tuple(want.output_paths) == (
        "grads/layers/wfc",)
    assert got.kind == "inherited" and got.primitive == "mul"
    assert "no pre-step state" in got.message


def _exp_overflow(x):
    return torch.exp(x * 100.0).sum()


def _zero_by_zero(x):
    d = x - x
    return d / d


def _log_negative(x):
    return torch.log(x - 2.0)


class _BadBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 1.0

    @staticmethod
    def backward(ctx, g):
        return g / torch.zeros_like(g)


def _bad_backward(x):
    x = x.clone().requires_grad_()
    _BadBackward.apply(x).sum().backward()
    return x.grad


@pytest.mark.parametrize("fn,prim", [(_exp_overflow, "exp"),
                                     (_zero_by_zero, "div"),
                                     (_log_negative, "log"),
                                     (_bad_backward, "div")])
def test_probe_fn_names_the_origin(fn, prim):
    prov = probe.probe_fn(fn, torch.ones(4))
    assert (prov.ok, prov.kind, prov.primitive) == (False, "origin", prim)
    assert prov.input_paths == ()
    assert prov.source.split(" (")[1].rstrip(")") == (
        "backward" if fn is _bad_backward else fn.__name__)
    assert __file__ in prov.source


def test_probe_fn_names_a_poisoned_input_by_path():
    state = {"w": torch.ones(3), "b": {"x": torch.tensor([1.0, np.nan])},
             "n": torch.arange(3)}
    prov = probe.probe_fn(lambda s: s["w"] * s["b"]["x"].sum(), state)
    assert (prov.kind, prov.primitive, prov.input_paths) == (
        "inherited", "sum", ("b/x",))
    unread = probe.probe_fn(lambda s: s["w"] * 2, state)
    assert unread.kind == "inherited" and unread.primitive is None
    assert unread.input_paths == ("b/x",)


def test_probe_fn_on_a_finite_function():
    prov = probe.probe_fn(lambda a, b: (a @ b).softmax(-1), torch.ones(2, 3),
                          torch.ones(3, 2))
    assert prov.ok and prov.message == "replay stayed finite"


def test_a_reported_kernel_launch_is_the_origin():
    """A hand-written kernel runs out of ATen's sight; its wrapper's
    report makes it the origin under its own name, not the next op."""
    from torch.utils._python_dispatch import _disable_current_modes

    def fake_kernel(x):
        with _disable_current_modes():  # the ctypes launch: unseen
            y = torch.full_like(x, float("inf"))
        kernel_config.note_launch("flash_fwd", (x,), (y,))
        return y * 2.0

    prov = probe.probe_fn(fake_kernel, torch.ones(3))
    assert (prov.kind, prov.primitive) == ("origin", "flash_fwd")
    assert "fake_kernel" in prov.source
    assert kernel_config._LAUNCH_HOOK is None

    def unreported(x):
        with _disable_current_modes():
            return torch.full_like(x, float("nan"))

    prov = probe.probe_fn(unreported, torch.ones(3))
    assert prov.kind == "origin" and prov.primitive is None
    assert "unreplayable" in prov.message


def _loop_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(8, 4, generator=g),
            "b": torch.zeros(4), "count": torch.zeros((), dtype=torch.int64)}


def _in_place_step(state, step):
    """Updates its state in place, as the port's train steps do."""
    g = torch.Generator().manual_seed(100 + step)
    x = torch.randn(16, 8, generator=g)
    w = state["w"].detach().requires_grad_()
    loss = ((x @ w + state["b"]) ** 2).mean()
    (gw,) = torch.autograd.grad(loss, (w,))
    with torch.no_grad():
        state["w"].sub_(0.1 * gw)
        state["count"].add_(1)
    return state, {"loss": float(loss.detach())}


def _run(tmp_path, plan, probe_on, step_fn=_in_place_step, steps=4):
    reg = MetricRegistry()
    loop = ResilientTrainLoop(
        step_fn, directory=str(tmp_path / f"ck{int(probe_on)}"),
        save_every=1, fault_plan=FaultPlan.parse(plan), registry=reg,
        numerics_provenance=probe_on, memory_forensics=False)
    final = loop.run(_loop_state(), steps)
    return final, reg


def test_loop_reports_provenance_and_ends_bit_for_bit(tmp_path):
    on, reg_on = _run(tmp_path, "nan_grads@1", True)
    off, reg_off = _run(tmp_path, "nan_grads@1", False)
    for k in on:
        assert torch.equal(on[k], off[k]), k
    (ev,) = [e["fields"] for e in reg_on.events()
             if e["name"] == "numerics_provenance"]
    assert ev["step"] == 1 and ev["ok"] is False
    assert ev["kind"] == "inherited"
    assert ev["output_paths"] == ["b", "w"]
    assert "no pre-step state" in ev["message"]
    probes = [m.value for m in reg_on.metrics()
              if m.name == "numerics/probes"]
    assert probes == [1]
    assert not [e for e in reg_off.events()
                if e["name"] == "numerics_provenance"]
    (rollback,) = [e["fields"] for e in reg_on.events()
                   if e["name"] == "rollback"]
    assert rollback["numerics"]["kind"] == "inherited"


def _log_in_place(state, step):
    """Takes the log of a negative into its state, in place."""
    del step
    with torch.no_grad():
        state["b"].copy_(torch.log(state["b"] - 1.0))
    return state, {}


def test_loop_names_an_in_step_origin_from_the_start_copy():
    """A step that makes a NaN itself, updating its state in place, at
    the run's first step: the loop replays it on its host copy of the
    starting state and names the op and its line as the origin."""
    from apex_tpu_torch.resilience import TrainAborted

    reg = MetricRegistry()
    loop = ResilientTrainLoop(_log_in_place, registry=reg, max_rollbacks=0,
                              memory_forensics=False)
    state = _loop_state()
    with pytest.raises(TrainAborted) as err:
        loop.run(state, 1)
    (ev,) = [e["fields"] for e in reg.events()
             if e["name"] == "numerics_provenance"]
    assert (ev["kind"], ev["primitive"]) == ("origin", "log")
    assert "_log_in_place" in ev["source"]
    assert ev["output_paths"] == ["b"]
    assert err.value.report["numerics"]["primitive"] == "log"
