"""The port's ResilientTrainLoop against the JAX package's, case by case
(the cases of tests/run_resilience/test_loop_chaos.py).

Each case runs through both packages with the same fault spec and a step
that computes the same arithmetic from the same numpy-seeded gradients
(Adam, lr 1e-2, on a 4 x 4 weight and a 4-vector bias). The port's step
updates its params IN PLACE, as the port's ``train_step`` does. Compared
between the packages: the sequence of registry events (name and step),
every ``resilience/*`` counter, ``Preempted.step``, the keys of the
``TrainAborted`` report. Both loops run without their NaN probe and OOM
forensics (``numerics_provenance=False, memory_forensics=False``), which
``tests/test_torch_obs_memory.py`` holds. The final state lies within 1e-6
relative of the JAX run's (fp32, the same operations) and is bit for bit
the port's own uninterrupted run.
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as jax_ckpt
from apex_tpu import observability as jax_obs
from apex_tpu import resilience as jax_res
from apex_tpu.amp import scaled_update as jax_scaled_update
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch import resilience as port_res
from apex_tpu_torch.amp.scaler import LossScaler as PortLossScaler
from apex_tpu_torch.amp.scaler import scaled_update as port_scaled_update
from apex_tpu_torch.optimizers import fused_adam as port_fused_adam

REL = 1e-6


def _grads(step: int) -> dict:
    rng = np.random.default_rng(1000 + step)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


class _Jax:
    name = "jax"
    ckpt = jax_ckpt
    res = jax_res

    def __init__(self):
        self.tx = jax_fused_adam(lr=1e-2)

    def registry(self):
        return jax_obs.MetricRegistry()

    def loop(self, step_fn, **kw):
        return jax_res.ResilientTrainLoop(
            step_fn, numerics_provenance=False, memory_forensics=False, **kw)

    def init_state(self):
        params = {"w": jnp.ones((4, 4)), "b": jnp.zeros((4,))}
        return {"params": params, "opt": self.tx.init(params)}

    def update(self, state, grads, scaler=None):
        params = state["params"]
        if scaler is None:
            updates, opt = self.tx.update(grads, state["opt"], params)
            extra, overflow = {}, False
        else:
            updates, opt, sstate, overflow = jax_scaled_update(
                self.tx, scaler, grads, state["opt"], params,
                state["scaler"])
            extra, overflow = {"scaler": sstate}, bool(overflow)
        params = jax.tree_util.tree_map(jnp.add, params, updates)
        return {"params": params, "opt": opt, **extra}, overflow

    def step_fn(self, state, step):
        grads = {k: jnp.asarray(v) for k, v in _grads(step).items()}
        new, _ = self.update(state, grads)
        return new, {"loss": _loss(self, new)}

    def leaves(self, state):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]

    def scaler(self, **kw):
        return JaxLossScaler(**kw)


class _Port:
    name = "port"
    ckpt = port_ckpt
    res = port_res

    def __init__(self):
        self.tx = port_fused_adam(lr=1e-2)

    def registry(self):
        return port_obs.MetricRegistry()

    def loop(self, step_fn, **kw):
        return port_res.ResilientTrainLoop(
            step_fn, numerics_provenance=False, memory_forensics=False, **kw)

    def init_state(self):
        params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
        return {"params": params, "opt": self.tx.init(params)}

    def update(self, state, grads, scaler=None):
        params = state["params"]
        with torch.no_grad():
            if scaler is None:
                updates, opt = self.tx.update(grads, state["opt"], params)
                extra, overflow = {}, False
            else:
                updates, opt, sstate, overflow = port_scaled_update(
                    self.tx, scaler, grads, state["opt"], params,
                    state["scaler"])
                extra, overflow = {"scaler": sstate}, bool(overflow)
            for p, u in zip(_tree.flatten(params)[0],
                            _tree.flatten(updates)[0]):
                p.add_(u)  # in place, as the port's train_step
        return {"params": params, "opt": opt, **extra}, overflow

    def step_fn(self, state, step):
        grads = {k: torch.from_numpy(v) for k, v in _grads(step).items()}
        new, _ = self.update(state, grads)
        return new, {"loss": _loss(self, new)}

    def leaves(self, state):
        return [x.numpy().copy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in _tree.flatten(state)[0]]

    def scaler(self, **kw):
        return PortLossScaler(**kw)


def _loss(side, state) -> float:
    return float(sum(np.sum(p.astype(np.float64) ** 2)
                     for p in side.leaves(state["params"])))


SIDES = (_Jax(), _Port())


#: events of the reference's NaN probe and OOM forensics, which its
#: ``chaos_probe`` runs with no way to turn them off
PROBE_EVENTS = ("numerics_provenance", "memory_verdict")


def _events(reg):
    return [(e["name"], (e.get("fields") or {}).get("step"))
            for e in reg.events() if e["name"] not in PROBE_EVENTS]


def _counters(reg):
    return {(m.name, tuple(sorted(m.labels.items()))): m.value
            for m in reg.metrics()
            if m.kind == "counter" and m.name.startswith("resilience/")}


def _clean(side, directory, steps=12, save_every=4):
    return side.leaves(side.loop(side.step_fn, directory=directory,
                                 save_every=save_every).run(
        side.init_state(), steps))


def _assert_bit_identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _policy(side, reg, **kw):
    kw.setdefault("max_attempts", 3)
    return side.res.Policy(initial_backoff=0.001, sleep=lambda s: None,
                           registry=reg, **kw)


# ------------------------------------------------------------- the cases

def case_preempt_crash_restart(side, tmp):
    clean = _clean(side, str(tmp / "clean"))
    chaos = str(tmp / "chaos")
    reg = side.registry()
    with pytest.raises(side.res.Preempted) as ei:
        side.loop(side.step_fn, directory=chaos, save_every=4,
                  fault_plan=side.res.FaultPlan.parse("preempt@6"),
                  registry=reg).run(side.init_state(), 12)
    assert ei.value.exit_code == side.res.EXIT_PREEMPTED
    assert side.ckpt.validate_step_dir(ei.value.checkpoint_path, deep=True)
    resumed = []
    loop2 = side.loop(side.step_fn, directory=chaos, save_every=4,
                      fault_plan=side.res.FaultPlan.parse("preempt@6"),
                      registry=reg, on_resume=resumed.append)
    final = side.leaves(loop2.run(side.init_state(), 12))
    assert resumed == [6] and loop2.resumed_from == 6
    return clean, final, reg, {"preempted": ei.value.step}


def case_torn_emergency_checkpoint(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=10, save_every=2)
    chaos = str(tmp / "chaos")
    reg = side.registry()
    with pytest.raises(side.res.Preempted) as ei:
        side.loop(side.step_fn, directory=chaos, save_every=2,
                  fault_plan=side.res.FaultPlan.parse(
                      "preempt@5,ckpt_torn@5"),
                  registry=reg).run(side.init_state(), 10)
    assert ei.value.checkpoint_path is None
    assert os.path.isdir(os.path.join(chaos, "step_00000005.tmp"))
    assert side.ckpt.latest_valid_step(chaos) == 4
    loop2 = side.loop(side.step_fn, directory=chaos, save_every=2,
                      fault_plan=side.res.FaultPlan.parse("ckpt_torn@5"),
                      registry=reg)
    final = side.leaves(loop2.run(side.init_state(), 10))
    assert loop2.resumed_from == 4
    return clean, final, reg, {"preempted": ei.value.step}


def case_torn_periodic_save_retried(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=8, save_every=2)
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "chaos"), save_every=2,
        fault_plan=side.res.FaultPlan.parse("ckpt_torn@4"),
        retry_policy=_policy(side, reg, name="loop"),
        registry=reg).run(side.init_state(), 8))
    return clean, final, reg, {
        "latest": side.ckpt.latest_valid_step(str(tmp / "chaos"))}


def case_nan_storm_rolls_back(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=10, save_every=2)
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "chaos"), save_every=2,
        fault_plan=side.res.FaultPlan.parse("nan_grads@5"),
        registry=reg).run(side.init_state(), 10))
    return clean, final, reg, {}


def case_transient_step_exception_retried(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=8, save_every=0)
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "chaos"),
        fault_plan=side.res.FaultPlan.parse("step_exc@3"),
        retry_policy=_policy(side, reg, name="loop", retry_on=(
            OSError, side.res.TransientStepError)),
        registry=reg).run(side.init_state(), 8))
    return clean, final, reg, {}


def case_unretried_step_exception_rolls_back(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=8, save_every=2)
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "chaos"), save_every=2,
        fault_plan=side.res.FaultPlan.parse("step_exc@5"),
        registry=reg).run(side.init_state(), 8))
    return clean, final, reg, {}


def case_abort_ladder_report(side, tmp):
    reg = side.registry()
    loop = side.loop(side.step_fn, directory=str(tmp / "c"), save_every=2,
                     validate=lambda state, metrics, step: step < 3,
                     max_rollbacks=2, registry=reg)
    with pytest.raises(side.res.TrainAborted) as ei:
        loop.run(side.init_state(), 10)
    report = ei.value.report
    assert report["step"] == 3 and report["rollbacks"] == 2
    assert report["reason"] == "rollback budget exhausted"
    assert report["counters"]["resilience/rollbacks"] == 3
    return None, None, reg, {"report_keys": sorted(report),
                             "counters": report["counters"]}


def case_overflow_is_a_skip(side, tmp):
    reg = side.registry()

    def step_fn(state, step):
        if step == 2:  # the scaler's skip step
            return state, {"loss": float("inf"), "overflow": True}
        return side.step_fn(state, step)

    final = side.leaves(side.loop(step_fn, registry=reg).run(
        side.init_state(), 5))
    return None, final, reg, {}


def case_amp_scaler_state_survives_preempt(side, tmp):
    scaler = side.scaler(init_scale=2.0 ** 8, scale_window=1000)

    def init_state():
        return {**side.init_state(), "scaler": scaler.init()}

    def step_fn(state, step):
        grads = _grads(step)
        if step == 2:  # a genuine overflow through the scaler
            grads = {k: v * np.float32(np.inf) for k, v in grads.items()}
        grads = {k: (jnp.asarray(v) if side.name == "jax"
                     else torch.from_numpy(v)) for k, v in grads.items()}
        new, overflow = side.update(state, grads, scaler)
        return new, {"loss": float(side.leaves(new["params"])[1].sum()),
                     "overflow": overflow}

    clean_state = side.loop(step_fn, directory=str(tmp / "clean"),
                            save_every=3).run(init_state(), 9)
    assert int(clean_state["scaler"].overflows) == 1
    assert float(clean_state["scaler"].loss_scale) == 2.0 ** 7
    chaos = str(tmp / "chaos")
    reg = side.registry()
    with pytest.raises(side.res.Preempted):
        side.loop(step_fn, directory=chaos, save_every=3, registry=reg,
                  fault_plan=side.res.FaultPlan.parse("preempt@4")).run(
            init_state(), 9)
    final = side.leaves(side.loop(step_fn, directory=chaos, save_every=3,
                                  registry=reg).run(init_state(), 9))
    return side.leaves(clean_state), final, reg, {}


def case_no_directory_preempts(side, tmp):
    reg = side.registry()
    with pytest.raises(side.res.Preempted) as ei:
        side.loop(side.step_fn, registry=reg,
                  fault_plan=side.res.FaultPlan.parse("preempt@3")).run(
            side.init_state(), 8)
    assert ei.value.checkpoint_path is None
    return None, None, reg, {"preempted": ei.value.step}


def case_resume_past_num_steps(side, tmp):
    d = str(tmp / "c")
    reg = side.registry()
    side.loop(side.step_fn, directory=d, save_every=2, registry=reg).run(
        side.init_state(), 6)
    loop = side.loop(side.step_fn, directory=d, save_every=2, registry=reg)
    final = side.leaves(loop.run(side.init_state(), 4))
    return None, final, reg, {"resumed_from": loop.resumed_from}


def case_async_final_commit_failure(side, tmp):
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "c"), save_every=3,
        async_save=True, fault_plan=side.res.FaultPlan.parse("ckpt_torn@7"),
        registry=reg).run(side.init_state(), 8))
    clean = _clean(side, str(tmp / "clean"), steps=8, save_every=3)
    return clean, final, reg, {
        "latest": side.ckpt.latest_valid_step(str(tmp / "c"))}


def case_legacy_markerless_resumed(side, tmp):
    d = str(tmp / "c")
    reg = side.registry()
    side.loop(side.step_fn, directory=d, save_every=2, registry=reg).run(
        side.init_state(), 6)
    for name in os.listdir(d):
        marker = os.path.join(d, name, side.ckpt.COMMIT_MARKER)
        if os.path.exists(marker):
            os.remove(marker)
    assert side.ckpt.latest_valid_step(d) is None
    loop = side.loop(side.step_fn, directory=d, save_every=2, registry=reg)
    final = side.leaves(loop.run(side.init_state(), 10))
    clean = _clean(side, str(tmp / "clean"), steps=10, save_every=2)
    return clean, final, reg, {"resumed_from": loop.resumed_from}


def case_rollback_budget_resets(side, tmp):
    clean = _clean(side, str(tmp / "clean"), steps=20, save_every=2)
    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, directory=str(tmp / "chaos"), save_every=2,
        fault_plan=side.res.FaultPlan.parse("nan_grads@4+9+14"),
        max_rollbacks=1, registry=reg).run(side.init_state(), 20))
    return clean, final, reg, {}


def case_chaos_matrix(side, tmp):
    """test_chaos_matrix_probabilistic_plans_bit_identical at 2 seeds and
    12 steps: seeded storms of every fault kind, restarted to
    completion."""
    clean = _clean(side, str(tmp / "clean"), steps=12, save_every=3)
    reg = side.registry()
    finals = []
    for seed in range(2):
        spec = (f"seed={seed},preempt~0.1,ckpt_torn~0.15,"
                f"ckpt_enospc~0.1,step_exc~0.15,nan_grads~0.1")
        final = None
        for _ in range(20):
            loop = side.loop(
                side.step_fn, directory=str(tmp / f"chaos{seed}"),
                save_every=3, fault_plan=side.res.FaultPlan.parse(spec),
                retry_policy=_policy(side, reg, seed=seed, retry_on=(
                    OSError, side.res.TransientStepError)),
                max_rollbacks=50, registry=reg)
            try:
                final = side.leaves(loop.run(side.init_state(), 12))
                break
            except side.res.Preempted:
                continue
        assert final is not None
        _assert_bit_identical(clean, final)
        finals.append(final)
    return clean, finals[-1], reg, {}


def case_chaos_probe_summary(side, tmp):
    reg = side.registry()
    kw = {"device": "cpu"} if side.name == "port" else {}
    summary = side.res.chaos_probe(
        "preempt@7,ckpt_torn@4,step_exc@2,nan_grads@9", str(tmp),
        steps=14, registry=reg, **kw)
    assert summary["completed"] is True and summary["restarts"] == 1
    del summary["final_param_sum"]  # each package draws its own gradients
    return None, None, reg, {"summary": summary}


CASES = [case_preempt_crash_restart, case_torn_emergency_checkpoint,
         case_torn_periodic_save_retried, case_nan_storm_rolls_back,
         case_transient_step_exception_retried,
         case_unretried_step_exception_rolls_back, case_abort_ladder_report,
         case_overflow_is_a_skip, case_amp_scaler_state_survives_preempt,
         case_no_directory_preempts, case_resume_past_num_steps,
         case_chaos_probe_summary, case_chaos_matrix,
         case_async_final_commit_failure, case_legacy_markerless_resumed,
         case_rollback_budget_resets]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_matches_the_jax_loop(case, tmp_path):
    got = {}
    for side in SIDES:
        clean, final, reg, extra = case(side, tmp_path / side.name)
        if clean is not None:
            _assert_bit_identical(clean, final)
        got[side.name] = (final, _events(reg), _counters(reg), extra)
    (jf, je, jc, jx), (pf, pe, pc, px) = got["jax"], got["port"]
    assert pe == je
    assert pc == jc
    assert px == jx
    if jf is not None:
        for a, b in zip(pf, jf):
            np.testing.assert_allclose(a, b, rtol=REL, atol=REL)


# ------------------------------------------------------ port-only cases

def _port_clean(steps, save_every=0, directory=None):
    side = SIDES[1]
    return side.leaves(side.loop(side.step_fn, directory=directory,
                                 save_every=save_every).run(
        side.init_state(), steps))


@pytest.mark.parametrize("spec", ["nan_grads@3", "step_exc@3",
                                  "nan_grads@0+5"])
def test_rollback_without_directory_restores_the_starting_values(spec):
    """No checkpoint: a rollback goes to the run's starting state. The
    step has updated the params in place by then, so the loop's host
    copy of the start is what makes the replay bit for bit."""
    side = SIDES[1]
    reg = side.registry()
    state = side.init_state()
    final = side.leaves(side.loop(
        side.step_fn, fault_plan=side.res.FaultPlan.parse(spec),
        registry=reg).run(state, 8))
    assert reg.counter("resilience/rollbacks").value == spec.count("+") + 1
    _assert_bit_identical(_port_clean(8), final)


def test_async_chaos_restart_bit_identical(tmp_path):
    """Async saves under a torn write, a NaN storm and a preemption,
    then a fresh loop: bit for bit the clean run."""
    side = SIDES[1]
    clean = _port_clean(10, save_every=2, directory=str(tmp_path / "clean"))
    d = str(tmp_path / "chaos")
    reg = side.registry()
    spec = "nan_grads@5,ckpt_torn@4,preempt@7"
    with pytest.raises(side.res.Preempted) as ei:
        side.loop(side.step_fn, directory=d, save_every=2, async_save=True,
                  fault_plan=side.res.FaultPlan.parse(spec),
                  registry=reg).run(side.init_state(), 10)
    assert ei.value.step == 7
    loop = side.loop(side.step_fn, directory=d, save_every=2,
                     async_save=True, registry=reg)
    final = side.leaves(loop.run(side.init_state(), 10))
    assert loop.resumed_from == 7
    _assert_bit_identical(clean, final)
    assert port_ckpt.valid_steps(d) == [7, 8, 9]


def _chip_plan() -> str:
    """``chip_smoke.py``'s RESILIENT_PLAN, read from the script."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_plan", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.RESILIENT_PLAN


CHIP_PLAN = _chip_plan()


def _chip_plan_run(side, d, step_fn, init_state, steps=6):
    """chip_smoke.py's gpt2_resilient schedule: async saves every 2 steps,
    2 kept, retries on OSError and injected faults, then a fresh loop."""
    reg = side.registry()

    def loop(plan):
        return side.loop(
            step_fn, directory=d, save_every=2, async_save=True,
            max_to_keep=2, fault_plan=side.res.FaultPlan.parse(plan),
            retry_policy=_policy(side, reg, retry_on=(
                OSError, side.res.FaultInjected)),
            registry=reg)

    with pytest.raises(side.res.Preempted) as ei:
        loop(CHIP_PLAN).run(init_state(), steps)
    resumed = loop(CHIP_PLAN)
    final = resumed.run(init_state(), steps)
    return reg, ei.value.step, resumed.resumed_from, final


def test_chip_schedule_matches_the_jax_loop(tmp_path):
    """The gpt2_resilient phase's fault schedule gives the JAX loop's
    events and counters (the step-0 write is still in flight when step 1
    is poisoned, so the rollback replays from the start; the emergency
    save at step 3 is torn at its commit, retried once, and commits)."""
    got = {}
    for side in SIDES:
        d = str(tmp_path / side.name)
        reg, preempted, resumed, final = _chip_plan_run(
            side, d, side.step_fn, side.init_state)
        got[side.name] = (_events(reg), _counters(reg), preempted, resumed,
                          side.ckpt.valid_steps(d), side.leaves(final))
    assert got["port"][:5] == got["jax"][:5]
    assert got["port"][2:4] == (3, 3)
    events, counters = got["port"][:2]
    assert not [e for e in events if e[0].endswith("_failed")]
    assert counters[("resilience/retries", (("scope", "default"),))] == 1
    assert ("resilience/checkpoint_failures", ()) not in counters
    for a, b in zip(got["port"][5], got["jax"][5]):
        np.testing.assert_allclose(a, b, rtol=REL, atol=REL)


def test_gpt2_tiny_preempted_and_resumed_bit_for_bit(tmp_path):
    """GPT-2 ``tiny()`` with tree-mode Adam (params updated in place, a
    new optimizer state each step) under the chip schedule, against its
    uninterrupted run; the resumed loop's template is drawn from another
    seed, so the restore has to overwrite it."""
    from apex_tpu_torch.models import gpt2
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt2.tiny()
    tx = fused_adam(lr=1e-3)

    def init_state(seed=0):
        params = gpt2.init_params(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
        return {"params": params, "opt": tx.init(params)}

    def step_fn(state, step):
        gen = torch.Generator().manual_seed(step)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        params, opt, loss = gpt2.train_step(
            state["params"], state["opt"],
            (tokens, torch.roll(tokens, -1, dims=-1)), cfg, tx, remat=False)
        return {"params": params, "opt": opt}, {"loss": float(loss)}

    side = SIDES[1]
    clean = side.leaves(side.loop(step_fn).run(init_state(), 6))
    seeds = iter((0, 1))
    reg, preempted, resumed, final = _chip_plan_run(
        side, str(tmp_path / "c"), step_fn,
        lambda: init_state(next(seeds)))
    assert (preempted, resumed) == (3, 3)
    _assert_bit_identical(clean, side.leaves(final))
    assert reg.counter("resilience/rollbacks").value == 1
    assert reg.counter("resilience/emergency_saves").value == 1
    assert reg.counter("resilience/resumes").value == 1
    for kind in ("nan_grads", "ckpt_torn", "preempt"):
        assert reg.counter("resilience/faults_injected",
                           kind=kind).value == 1


def test_exit_on_preempt_exits_75(tmp_path):
    side = SIDES[1]
    with pytest.raises(SystemExit) as ei:
        side.loop(side.step_fn, directory=str(tmp_path), save_every=2,
                  exit_on_preempt=True,
                  fault_plan=side.res.FaultPlan.parse("preempt@2"),
                  registry=side.registry()).run(side.init_state(), 6)
    assert ei.value.code == 75
    assert port_ckpt.latest_valid_step(str(tmp_path)) == 2


@pytest.mark.parametrize("kind", ["oom", "stall"])
def test_oom_and_stall_faults(kind):
    """``oom`` is a failed step (a rollback), ``stall`` a slow one; the
    flight recorder brackets every attempt."""
    side = SIDES[1]
    calls = []

    class Recorder:
        def step_started(self, step):
            calls.append(("start", step))

        def step_finished(self, record=True):
            calls.append(("finish", record))

    reg = side.registry()
    final = side.leaves(side.loop(
        side.step_fn, fault_plan=side.res.FaultPlan.parse(f"{kind}@2"),
        stall_s=0.01, flight_recorder=Recorder(), registry=reg).run(
        side.init_state(), 4))
    _assert_bit_identical(_port_clean(4), final)
    assert reg.counter("resilience/faults_injected", kind=kind).value == 1
    assert reg.counter("resilience/rollbacks").value == (kind == "oom")
    assert ("finish", False) in calls if kind == "oom" else (
        ("finish", False) not in calls)
