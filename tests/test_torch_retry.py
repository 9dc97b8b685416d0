"""The port's retry policy (apex_tpu_torch.resilience.retry) against the
JAX package's: the same seed gives the same backoff sequence, float for
float, and the same calls give the same attempts, sleeps, give-ups,
counters and events."""

import pytest
import torch

from apex_tpu import observability as jax_obs
from apex_tpu.resilience import retry as jax_retry
from apex_tpu.resilience.faults import TransientStepError as JaxTransient
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch.resilience import retry as port_retry
from apex_tpu_torch.resilience.faults import (
    TransientStepError as PortTransient,
)

SIDES = {"jax": (jax_retry, jax_obs, JaxTransient),
         "port": (port_retry, port_obs, PortTransient)}


class _Flaky:
    def __init__(self, fail_times, exc):
        self.calls = 0
        self.fail_times = fail_times
        self.exc = exc

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc
        return "ok"


def _record(reg):
    counters = {(m.name, tuple(sorted(m.labels.items()))): m.value
                for m in reg.metrics() if m.kind == "counter"}
    events = [(e["name"], e["fields"]["scope"], e["fields"]["attempts"],
               e["fields"]["deadline_expired"]) for e in reg.events()]
    return counters, events


def _run(side, fail_times, exc_name, **kw):
    retry, obs, transient = SIDES[side]
    exc = {"os": OSError("transient"), "perm": PermissionError("denied"),
           "gone": FileNotFoundError("gone"), "bug": TypeError("bug"),
           "step": transient("flaky")}[exc_name]
    if "rules" in kw:
        kw["rules"] = {transient if k == "step" else PermissionError: v
                       for k, v in kw["rules"].items()}
    if kw.get("retry_on") == "step":
        kw["retry_on"] = (OSError, transient)
    reg = obs.MetricRegistry()
    sleeps = []
    policy = retry.Policy(registry=reg, sleep=sleeps.append, seed=7,
                          name="io", **kw)
    fn = _Flaky(fail_times, exc)
    try:
        out = policy.call(fn)
    except Exception as e:  # noqa: BLE001 — compared across packages
        out = type(e).__name__
    return out, fn.calls, sleeps, _record(reg)


CASES = {
    "retries_then_succeeds": (2, "os", dict(max_attempts=4)),
    "gives_up": (10, "os", dict(max_attempts=3)),
    "not_retryable": (1, "bug", dict(max_attempts=5)),
    "class_rule_longer": (3, "step", dict(max_attempts=2, retry_on="step",
                                          rules={"step": 5})),
    "class_rule_never": (1, "perm", dict(max_attempts=5,
                                         rules={"perm": 1})),
    "no_retry_wins": (1, "gone", dict(max_attempts=5,
                                      no_retry=(FileNotFoundError,))),
    "deadline_zero": (50, "os", dict(max_attempts=100, deadline_s=0.0)),
    "capped_backoff": (6, "os", dict(max_attempts=8, initial_backoff=0.1,
                                     max_backoff=0.5, jitter=0.25)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_matches_the_jax_policy(case):
    fail_times, exc, kw = CASES[case]
    jax_out = _run("jax", fail_times, exc, **dict(kw))
    port_out = _run("port", fail_times, exc, **dict(kw))
    assert port_out == jax_out


@pytest.mark.parametrize("seed", [0, 42, 12345])
def test_backoff_sequence_is_the_jax_sequence(seed):
    kw = dict(seed=seed, initial_backoff=0.1, max_backoff=0.5,
              multiplier=2.0, jitter=0.25)
    a = port_retry.Policy(**kw)
    b = jax_retry.Policy(**kw)
    seq = [a.backoff(i) for i in range(1, 12)]
    assert seq == [b.backoff(i) for i in range(1, 12)]
    assert all(0.0 <= d <= 0.5 * 1.25 + 1e-9 for d in seq)


def test_deadline_and_wrap():
    t = [0.0]
    d = port_retry.Deadline(10.0, clock=lambda: t[0])
    assert d.remaining() == 10.0 and not d.expired()
    t[0] = 11.0
    assert d.expired() and d.remaining() == 0.0
    reg = port_obs.MetricRegistry()
    fn = _Flaky(1, OSError("x"))
    wrapped = port_retry.Policy(max_attempts=3, sleep=lambda s: None,
                                registry=reg).wrap(lambda: fn())
    assert wrapped() == "ok" and fn.calls == 2
    assert reg.counter("resilience/retries", scope="default").value == 1
    with pytest.raises(ValueError, match="max_attempts"):
        port_retry.Policy(max_attempts=0)
    assert port_retry.DEFAULT_RETRYABLE == jax_retry.DEFAULT_RETRYABLE


def test_timer_times_and_scopes():
    """The registry's Timer, which the loop times its phases with."""
    reg = port_obs.MetricRegistry()
    timer = reg.timer("resilience/ckpt_save_s")
    assert reg.timer("resilience/ckpt_save_s") is timer
    timer.start()
    with pytest.raises(RuntimeError, match="already running"):
        timer.start()
    first = timer.stop(block_on={"x": [torch.zeros(2)]})
    assert first >= 0.0
    with pytest.raises(RuntimeError, match="not running"):
        timer.stop()
    timer.start()
    timer.cancel()  # not recorded
    timer.start()
    second = timer.stop()
    rec = timer.to_record()
    assert rec["type"] == "timer" and rec["count"] == 2 and rec["unit"] == "s"
    assert rec["total_elapsed"] == pytest.approx(first + second)
