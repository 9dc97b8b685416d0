"""The port's fault plan and preemption watcher (apex_tpu_torch.resilience)
against the JAX package's: the same spec parses to the same canonical
spec and fires at the same steps, fixed and seeded, with the reference's
spending; the watcher's sensors, trip, signal folding and registry
counters behave as ``tests/run_resilience/test_preemption.py`` checks
them; ``Preempted`` carries exit code 75.
"""

import os
import signal

import pytest

from apex_tpu.resilience import faults as jax_faults
from apex_tpu.resilience.loop import Preempted as JaxPreempted
from apex_tpu_torch.observability import MetricRegistry
from apex_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    KINDS,
    FaultPlan,
    InjectedOom,
    Preempted,
    PreemptionWatcher,
    env_sensor,
    file_sensor,
)

SPECS = ["seed=7,preempt@12,ckpt_torn@4+9,nan_grads~0.5",
         "seed=3,step_exc~0.3",
         "seed=4,step_exc~0.3,preempt@0+199",
         "preempt@5,oom~0.05,stall~0.02",
         "seed=11,preempt~0.01,ckpt_enospc~1.0,ckpt_torn~0.0",
         ""]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_round_trips_as_the_reference(spec):
    plan, ref = FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    assert plan.spec() == ref.spec()
    assert repr(plan) == repr(ref)
    assert FaultPlan.parse(plan.spec()).spec() == plan.spec()
    assert plan.seed == ref.seed


@pytest.mark.parametrize("spec", SPECS)
def test_firings_over_200_steps_equal_the_reference(spec):
    """``scheduled`` (pure) and ``should_fire`` (spending) give the
    reference's sequences for every kind, twice over: the second pass
    finds every fault spent, and ``reset`` re-arms them."""
    plan, ref = FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    for kind in KINDS:
        assert [plan.scheduled(kind, s) for s in range(200)] == [
            ref.scheduled(kind, s) for s in range(200)]
    for _ in range(2):
        got = [(k, s) for s in range(200) for k in KINDS
               if plan.should_fire(k, s)]
        want = [(k, s) for s in range(200) for k in KINDS
                if ref.should_fire(k, s)]
        assert got == want
    assert [plan.faults_at(s) for s in range(200)] == [
        ref.faults_at(s) for s in range(200)]
    plan.reset()
    ref.reset()
    assert [plan.should_fire(k, s, spend=False) for s in range(50)
            for k in KINDS] == [ref.should_fire(k, s, spend=False)
                                for s in range(50) for k in KINDS]


def test_probabilistic_draws_depend_on_the_seed():
    a = [FaultPlan.parse("seed=3,step_exc~0.3").scheduled("step_exc", s)
         for s in range(200)]
    b = [FaultPlan.parse("seed=4,step_exc~0.3").scheduled("step_exc", s)
         for s in range(200)]
    assert any(a) and not all(a) and a != b


def test_should_fire_spends_once_per_process():
    plan = FaultPlan.parse("preempt@5")
    assert plan.should_fire("preempt", 5)
    assert not plan.should_fire("preempt", 5)
    plan.reset()
    assert plan.should_fire("preempt", 5)


@pytest.mark.parametrize("spec", ["warp_core_breach@3", "preempt@x",
                                  "nan_grads~1.5", "preempt=3"])
def test_bad_specs_fail_as_the_reference(spec):
    with pytest.raises(ValueError) as ref:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(spec)
    assert str(got.value) == str(ref.value)


def test_fault_family_matches_the_reference():
    assert KINDS == jax_faults.KINDS
    exc = InjectedOom(3)
    assert str(exc) == str(jax_faults.InjectedOom(3))
    assert exc.requested_bytes == 1 << 30 and exc.step == 3


def test_preempted_carries_exit_code_75():
    exc = Preempted(7, "/ckpt", "sigterm")
    ref = JaxPreempted(7, "/ckpt", "sigterm")
    assert exc.exit_code == ref.exit_code == EXIT_PREEMPTED == 75
    assert str(exc) == str(ref)
    assert (exc.step, exc.checkpoint_path, exc.reason) == (7, "/ckpt",
                                                          "sigterm")
    assert "FAILED" in str(Preempted(1, None))


# -------------------------------------------------------------- watcher


def test_trip_is_idempotent_and_counts_once():
    reg = MetricRegistry()
    w = PreemptionWatcher(registry=reg)
    assert not w.preempted and w.reason is None
    w.trip("maintenance event")
    w.trip("second reason ignored")
    assert w.preempted and w.reason == "maintenance event"
    assert reg.counter("resilience/preemptions").value == 1
    events = [r for r in reg.to_records() if r.get("type") == "event"]
    assert [e["name"] for e in events] == ["preemption"]
    assert events[0]["fields"] == {"reason": "maintenance event"}


def test_file_and_env_sensors(tmp_path, monkeypatch):
    sentinel = str(tmp_path / "preempt")
    w = PreemptionWatcher(sensors=[file_sensor(sentinel)],
                          registry=MetricRegistry())
    assert not w.check()
    open(sentinel, "w").close()
    assert w.check() and "sentinel" in w.reason
    w = PreemptionWatcher(sensors=[env_sensor("APEX_TPU_TEST_PREEMPT")],
                          registry=MetricRegistry())
    monkeypatch.setenv("APEX_TPU_TEST_PREEMPT", "0")
    assert not w.check()
    monkeypatch.setenv("APEX_TPU_TEST_PREEMPT", "1")
    assert w.check() and w.reason == "env APEX_TPU_TEST_PREEMPT=1"


def test_broken_sensor_counts_but_does_not_kill_polling(tmp_path):
    sentinel = str(tmp_path / "s")

    def broken():
        raise RuntimeError("metadata server down")

    reg = MetricRegistry()
    w = PreemptionWatcher(sensors=[broken, file_sensor(sentinel)],
                          registry=reg)
    assert not w.check()
    open(sentinel, "w").close()
    assert w.check()
    assert reg.counter("resilience/sensor_errors").value >= 1


def test_signal_installs_folds_into_check_and_restores():
    """The handler only records the signal (it may interrupt a holder of
    the watcher's lock); ``check`` trips on the polling thread, once."""
    reg = MetricRegistry()
    prev = signal.getsignal(signal.SIGUSR1)
    with PreemptionWatcher(signals=(signal.SIGUSR1,), registry=reg) as w:
        with w._lock:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert w.preempted and w.reason is None
        assert w.check() and "SIGUSR1" in w.reason
        os.kill(os.getpid(), signal.SIGUSR1)
        assert w.check()
        assert reg.counter("resilience/preemptions").value == 1
    assert signal.getsignal(signal.SIGUSR1) is prev
