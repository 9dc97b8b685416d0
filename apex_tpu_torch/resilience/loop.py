"""ResilientTrainLoop: the runtime safety net around a user step function
(port of ``apex_tpu/resilience/loop.py``).

- **Auto-resume**: ``run`` garbage-collects torn-write leftovers,
  restores the newest *valid* checkpoint (:mod:`apex_tpu_torch.checkpoint`)
  and walks back to older valid steps when a restore fails. A run
  preempted and restarted reaches **bit-identical** state to an
  uninterrupted run, provided ``step_fn(state, step)`` is deterministic
  in its arguments (draw per-step randomness from a generator seeded by
  the step).
- **Periodic and emergency checkpoints** through
  :class:`~apex_tpu_torch.checkpoint.CheckpointManager` (async-capable);
  preemption flushes the async write, saves synchronously under the
  retry policy, then raises :class:`Preempted` (or exits with
  :data:`~apex_tpu_torch.resilience.preemption.EXIT_PREEMPTED`).
- **Degradation ladder**: an amp overflow (``metrics["overflow"]``) is
  a counted skip; non-finite state or metrics, or a step that kept
  failing through the retry policy, rolls back to the newest valid
  checkpoint and replays; more than ``max_rollbacks`` rollbacks without
  progress past the failure raise :class:`TrainAborted` with a report.

Every decision lands as a ``resilience/*`` counter or event under the
reference's names and fields.

The port's steps update tensors in place (``train_step`` adds into the
params, flat Adam updates its slabs), so the loop cannot keep the
starting state by holding a reference, as the reference does. A rollback
with a checkpoint restores in place from it. A run that starts with no
checkpoint to fall back to (no ``directory``, or a cold start) keeps a
host copy of its starting state, so "rollback to the run's starting
state" restores the values the run started from.

**OOM forensics** (``memory_forensics``, on by default): a step that
dies out of memory (``torch.OutOfMemoryError``, or a message with CUDA's
"out of memory") gets a ``memrec_*.json`` post-mortem and a verdict
(requested bytes, capacity, largest live tensor, the ``memory_monitor``'s
watermark) on its ``rollback`` event and ``TrainAborted.report
["memory"]`` (:func:`apex_tpu_torch.observability.memory.oom_forensics`).
**NaN provenance** (``numerics_provenance``, on by default): a step
that fails the finite check is replayed under
:func:`apex_tpu_torch.observability.numerics.step_provenance`, which names
the non-finite tensors, the first op (or hand-written kernel) that made
or consumed a non-finite value, and its source, on the ``rollback`` event
and ``TrainAborted.report["numerics"]``. The replay runs on copies: a
step that updated its state in place leaves no pre-step values behind
(unless the state is still the run's starting state, of which the loop
keeps a host copy), and the report then replays the failed state only.
The loop's own state never sees the replay.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.observability.numerics import nan_probe
from apex_tpu_torch.resilience import faults as faults_mod
from apex_tpu_torch.resilience.preemption import EXIT_PREEMPTED

__all__ = ["Preempted", "TrainAborted", "ResilientTrainLoop",
           "chaos_probe", "resume_path"]


class Preempted(RuntimeError):
    """Raised after the emergency checkpoint or dump when preemption
    tripped.

    ``exit_code`` is the resumable-exit contract
    (:data:`~apex_tpu_torch.resilience.preemption.EXIT_PREEMPTED`);
    ``step`` is the last COMPLETED step or iteration (resume continues
    at ``step + 1``); ``checkpoint_path`` is the emergency save or dump
    (None if there was none).
    """

    def __init__(self, step: int, checkpoint_path: Optional[str],
                 reason: str = ""):
        super().__init__(
            f"preempted after step {step}"
            + (f" ({reason})" if reason else "")
            + (f"; emergency checkpoint at {checkpoint_path}"
               if checkpoint_path else "; emergency checkpoint FAILED"))
        self.exit_code = EXIT_PREEMPTED
        self.step = step
        self.checkpoint_path = checkpoint_path
        self.reason = reason


class TrainAborted(RuntimeError):
    """The ladder's last rung: training cannot make progress. ``report``
    is a structured dict (step, rollbacks, last error, resume
    provenance, counter snapshot)."""

    def __init__(self, report: dict):
        super().__init__(f"training aborted at step {report.get('step')}: "
                         f"{report.get('reason')}")
        self.report = report


def _is_finite_number(v) -> bool:
    import math

    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError, RuntimeError):
        # non-numeric metric values are not health signals, nor is a
        # tensor of several elements (a gathered fleet fingerprint:
        # torch's float() raises RuntimeError where numpy's raises
        # TypeError)
        return True


def _all_finite(state) -> bool:
    """Every floating leaf of ``state`` finite: reduced on each device,
    one host sync a device."""
    flags: dict = {}
    for leaf in _tree.flatten(state)[0]:
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point():
                flags.setdefault(leaf.device, []).append(
                    torch.isfinite(leaf).all())
        elif isinstance(leaf, (np.ndarray, np.generic)) and np.issubdtype(
                leaf.dtype, np.inexact):
            if not np.isfinite(leaf).all():
                return False
    return all(bool(torch.stack(f).all()) for f in flags.values())


class ResilientTrainLoop:
    """Wrap ``step_fn(state, step) -> (state, metrics)`` with auto-resume,
    checkpointing, retries and the degradation ladder.

    Parameters, as in the reference (``loop.py:125``):

    step_fn: the user step. ``state`` is any tree of tensors (dicts,
        lists, tuples, NamedTuples; include the amp scaler's state);
        it may be updated in place. ``metrics`` is a dict: ``loss`` (and
        any float values) feed the health check, ``overflow`` marks an
        amp skip step.
    directory: checkpoint dir; None disables persistence (the ladder
        then rolls back to the run's starting state).
    save_every: periodic-save cadence in steps (a save also lands on the
        final step); 0 disables periodic saves.
    retry_policy: :class:`~apex_tpu_torch.resilience.retry.Policy`
        around the step call AND checkpoint I/O. None: no retries.
    fault_plan: :class:`~apex_tpu_torch.resilience.faults.FaultPlan`;
        ``run`` arms the checkpoint faults too.
    watcher: :class:`~apex_tpu_torch.resilience.preemption.
        PreemptionWatcher` polled after every step.
    stall_s: how long an injected ``stall`` sleeps inside the step.
    flight_recorder: any object with ``step_started(step)`` and
        ``step_finished(record=True)``, bracketing every step attempt
        (an :class:`apex_tpu_torch.observability.FlightRecorder`, whose
        watchdog dumps a post-mortem when one stalls). The loop does not
        install() it: callers own its lifecycle.
    numerics_provenance: run the NaN probe on health failures (module
        docstring); ticks ``numerics/probes`` and records a
        ``numerics_provenance`` event.
    memory_monitor: an
        :class:`apex_tpu_torch.observability.MemoryMonitor` whose
        watermark feeds the OOM verdict (default: the process's active
        monitor); ``memory_forensics=False`` disables the OOM
        post-mortem path. Costs nothing on healthy steps.
    desync_detector: any object with ``check(step, gathered)`` returning
        a verdict dict or None, fed ``metrics["fleet_fingerprint"]``; a
        verdict is a rollback.
    validate: ``f(state, metrics, step) -> bool`` health check override.
        Default: every float metric finite, and every
        ``check_state_every`` steps every floating state leaf finite.
    auto_resume: restore from ``directory`` on :meth:`run` entry.
    exit_on_preempt: ``sys.exit(EXIT_PREEMPTED)`` instead of raising
        :class:`Preempted`.
    on_resume: callback ``f(step)`` after a successful restore.
    """

    def __init__(self, step_fn: Callable[[Any, int], tuple], *,
                 directory: Optional[str] = None, save_every: int = 0,
                 max_to_keep: int = 3, async_save: bool = False,
                 retry_policy=None, fault_plan=None, watcher=None,
                 validate=None, check_state_every: int = 1,
                 max_rollbacks: int = 2, auto_resume: bool = True,
                 deep_validate_resume: bool = False,
                 exit_on_preempt: bool = False, on_resume=None,
                 registry=None, stall_s: float = 2.0,
                 flight_recorder=None, numerics_provenance: bool = True,
                 desync_detector=None, memory_monitor=None,
                 memory_forensics: bool = True):
        self.step_fn = step_fn
        self.directory = directory
        self.save_every = save_every
        self.retry_policy = retry_policy
        self.fault_plan = fault_plan
        self.watcher = watcher
        self.validate = validate
        self.check_state_every = check_state_every
        self.max_rollbacks = max_rollbacks
        self.auto_resume = auto_resume
        self.deep_validate_resume = deep_validate_resume
        self.exit_on_preempt = exit_on_preempt
        self.on_resume = on_resume
        self._registry = registry
        self.stall_s = float(stall_s)
        self.flight_recorder = flight_recorder
        self.numerics_provenance = numerics_provenance
        self.desync_detector = desync_detector
        self.memory_monitor = memory_monitor
        self.memory_forensics = memory_forensics
        self.manager = (ckpt.CheckpointManager(
            directory, max_to_keep=max_to_keep, async_save=async_save)
            if directory else None)
        #: step the last run() resumed from (None = cold start).
        self.resumed_from: Optional[int] = None
        # host copy of the starting state's tensors (see module docstring),
        # and whether the live state still holds those values
        self._start_copy: Optional[list] = None
        self._at_start = False

    # -------------------------------------------------------- plumbing

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability import get_registry
        return get_registry()

    def _call(self, fn, *args, **kwargs):
        if self.retry_policy is not None:
            return self.retry_policy.call(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    # ------------------------------------------------------ checkpoints

    def _save(self, state, step: int) -> Optional[str]:
        """Periodic save; a failure (after retries) degrades to a counter
        and an event. ``duration_s`` is the host seconds the save held
        the loop (with ``async_save``: the fence and the snapshot)."""
        reg = self._reg()
        timer = reg.timer("resilience/ckpt_save_s")
        timer.start()
        try:
            path = self._call(self.manager.save, step, {"state": state})
        except Exception as e:  # noqa: BLE001 — degradation rung 0
            duration = timer.stop()
            reg.counter("resilience/checkpoint_failures").inc()
            reg.event("checkpoint_failed", step=step, error=repr(e)[:200],
                      duration_s=round(duration, 6))
            return None
        duration = timer.stop()
        reg.event("checkpoint_saved", step=step,
                  duration_s=round(duration, 6))
        return path

    def _emergency_save(self, state, step: int) -> Optional[str]:
        """Synchronous, retry-wrapped save on preemption; flushes any
        in-flight async write first."""
        if self.manager is None:
            return None
        reg = self._reg()
        try:
            self.manager.wait_until_finished()
        except Exception as e:  # noqa: BLE001 — the async write may be
            # what is broken; the blocking save below still counts
            reg.event("emergency_flush_failed", step=step,
                      error=repr(e)[:200])
        timer = reg.timer("resilience/emergency_save_s")
        timer.start()
        try:
            path = self._call(ckpt.save_checkpoint, self.directory,
                              {"state": state}, step=step)
            timer.stop()
            reg.counter("resilience/emergency_saves").inc()
            return path
        except Exception as e:  # noqa: BLE001
            duration = timer.stop()
            reg.counter("resilience/checkpoint_failures").inc()
            reg.event("emergency_save_failed", step=step,
                      error=repr(e)[:200], duration_s=round(duration, 6))
            return None

    def _in_flight(self) -> tuple:
        writer = self.manager._writer if self.manager is not None else None
        tmp = writer.in_flight_tmp if writer is not None else None
        return (tmp,) if tmp else ()

    def _resume(self, state):
        """(state, start_step): restore the newest valid checkpoint into
        ``state``, walking back to older valid steps when a restore
        fails."""
        reg = self._reg()
        gc_timer = reg.timer("resilience/ckpt_gc_s")
        gc_timer.start()
        removed = ckpt.gc_partial_checkpoints(self.directory,
                                              keep=self._in_flight())
        gc_s = gc_timer.stop()
        if removed:
            reg.counter("resilience/gc_partial").inc(len(removed))
            reg.event("gc_partial_checkpoints",
                      removed=[p.rsplit("/", 1)[-1] for p in removed],
                      duration_s=round(gc_s, 6))
        candidates = list(reversed(ckpt.valid_steps(
            self.directory, deep=self.deep_validate_resume)))
        if not candidates:
            # no marker-bearing step: a dir from a writer without markers
            legacy = ckpt.latest_step(self.directory)
            if legacy is not None:
                candidates = [legacy]
        for step in candidates:
            restore_timer = reg.timer("resilience/ckpt_restore_s")
            restore_timer.start()
            try:
                restored = ckpt.restore_checkpoint(
                    self.directory, target={"state": state}, step=step)
            except Exception as e:  # noqa: BLE001 — walk back a step
                duration = restore_timer.stop()
                reg.counter("resilience/restore_failures").inc()
                reg.event("restore_failed", step=step,
                          error=repr(e)[:200],
                          duration_s=round(duration, 6))
                continue
            duration = restore_timer.stop(block_on=restored)
            reg.counter("resilience/resumes").inc()
            reg.event("resumed", step=step,
                      duration_s=round(duration, 6))
            self.resumed_from = step
            if self.on_resume is not None:
                self.on_resume(step)
            return restored["state"], step + 1
        return state, 0

    # ----------------------------------------------------- health check

    def _healthy(self, state, metrics, step: int) -> bool:
        if self.validate is not None:
            return bool(self.validate(state, metrics, step))
        for key, value in (metrics or {}).items():
            if key == "overflow":
                continue
            if not _is_finite_number(value):
                return False
        if self.check_state_every and step % self.check_state_every == 0:
            return _all_finite(state)
        return True

    # --------------------------------------------------- starting state

    def _keep_start(self, state) -> None:
        """Host copy of the starting state's tensors, when there is no
        checkpoint to fall back to."""
        self._start_copy = None
        if self.resumed_from is None:
            self._start_copy = [
                leaf.detach().to("cpu", copy=True)
                if isinstance(leaf, torch.Tensor) else None
                for leaf in _tree.flatten(state)[0]]
        self._at_start = self._start_copy is not None

    @torch.no_grad()
    def _restore_start(self, state) -> None:
        if self._start_copy is None:
            return
        for leaf, copy in zip(_tree.flatten(state)[0], self._start_copy):
            if copy is not None:
                leaf.copy_(copy)
        self._at_start = True

    def _pre_step_state(self, state, in_place: bool):
        """The state as it was before the step, for the NaN probe's
        replay: ``state`` itself when the step made new tensors; a device
        copy of the run's starting state when the step updated it
        ``in_place`` but it was that state; else None (no pre-step
        values)."""
        if not in_place:
            return state
        if not self._at_start:
            return None
        leaves, treedef = _tree.flatten(state)
        return treedef.unflatten([
            copy.to(leaf.device) if copy is not None else leaf
            for leaf, copy in zip(leaves, self._start_copy)])

    # -------------------------------------------------------------- run

    def run(self, state, num_steps: int):
        """Drive ``step_fn`` to ``num_steps`` completed steps; returns the
        final state. ``state`` doubles as the restore target (structure,
        shape and dtype of every leaf must match what was saved): a
        resume overwrites its tensors in place."""
        import contextlib

        with contextlib.ExitStack() as stack:
            if self.fault_plan is not None:
                stack.enter_context(faults_mod.inject_checkpoint_failures(
                    self.fault_plan, registry=self._registry))
            try:
                return self._run(state, num_steps)
            finally:
                self._start_copy = None

    def _attempt(self, step: int, state):
        """One call of the step, the plan's step faults injected."""
        reg = self._reg()
        plan = self.fault_plan
        recorder = self.flight_recorder
        if recorder is not None:
            recorder.step_started(step)
        try:
            if plan is not None and plan.should_fire("step_exc", step):
                reg.counter("resilience/faults_injected",
                            kind="step_exc").inc()
                raise faults_mod.TransientStepError(
                    f"injected transient failure at step {step}")
            if plan is not None and plan.should_fire("oom", step):
                reg.counter("resilience/faults_injected", kind="oom").inc()
                raise faults_mod.InjectedOom(step)
            if plan is not None and plan.should_fire("stall", step):
                # a hung step, not a failed one: only a watchdog sees it
                reg.counter("resilience/faults_injected",
                            kind="stall").inc()
                from apex_tpu_torch.observability import span

                with span("resilience/stall_fault"):
                    time.sleep(self.stall_s)
            result = self.step_fn(state, step)
        except BaseException:
            # a raised attempt's duration is not a step time
            if recorder is not None:
                recorder.step_finished(record=False)
            raise
        if recorder is not None:
            recorder.step_finished()
        return result

    def _run(self, state, num_steps: int):
        reg = self._reg()
        startup_timer = reg.timer("resilience/startup_s")
        startup_timer.start()
        self.resumed_from = None
        start = 0
        if self.manager is not None and self.auto_resume:
            state, start = self._resume(state)
        self._keep_start(state)
        reg.event("attempt_start", start_step=start,
                  num_steps=num_steps,
                  resumed=self.resumed_from is not None,
                  startup_s=round(startup_timer.stop(), 6))
        fallback_state, fallback_step = state, start
        plan = self.fault_plan
        step, rollbacks = start, 0
        # rollbacks bound failures WITHOUT intervening progress: once a
        # completed step passes the one that triggered the last
        # rollback, the budget resets
        recovery_target = -1

        while step < num_steps:
            step_timer = reg.timer("resilience/step_s")
            step_timer.start()
            # the state's version counters: the step updated it in place
            # if one moves (for the NaN probe's pre-step state)
            before = (nan_probe.versions(state)
                      if self.numerics_provenance else None)
            try:
                new_state, metrics = self._call(self._attempt, step, state)
            except (Preempted, TrainAborted, KeyboardInterrupt,
                    SystemExit):
                step_timer.cancel()
                raise
            except Exception as e:  # noqa: BLE001 — ladder rung 2
                step_timer.cancel()
                recovery_target = max(recovery_target, step)
                memory = self._probe_memory(e, step)
                state, step, rollbacks = self._rollback(
                    fallback_state, fallback_step, rollbacks, step, e,
                    memory=memory)
                continue
            reg.event("step_done", step=step,
                      duration_s=round(step_timer.stop(), 6))
            in_place = (before is not None
                        and nan_probe.versions(state) != before)

            if plan is not None and plan.should_fire("nan_grads", step):
                reg.counter("resilience/faults_injected",
                            kind="nan_grads").inc()
                new_state = faults_mod.corrupt_tree(new_state)

            # ---- health ladder
            overflow = bool((metrics or {}).get("overflow", False))
            if overflow:
                # rung 1: the amp scaler already skipped the update
                reg.counter("resilience/overflow_skips").inc()
            elif not self._healthy(new_state, metrics, step):
                error = ValueError(
                    f"non-finite state/metrics at step {step}")
                recovery_target = max(recovery_target, step)
                prov = self._probe_numerics(
                    self._pre_step_state(state, in_place), new_state, step)
                del new_state
                state, step, rollbacks = self._rollback(
                    fallback_state, fallback_step, rollbacks, step,
                    error, numerics=prov)
                continue

            # ---- fleet desync: healthy on every rank, yet divergent
            verdict = self._check_desync(metrics, step)
            if verdict is not None:
                error = ValueError(
                    f"cross-rank desync at step {step}: rank "
                    f"{verdict.get('rank')} diverged at "
                    f"{verdict.get('tensor_path')}")
                recovery_target = max(recovery_target, step)
                state, step, rollbacks = self._rollback(
                    fallback_state, fallback_step, rollbacks, step,
                    error, fleet=verdict)
                continue

            state = new_state
            self._at_start = False
            if rollbacks and step > recovery_target:
                rollbacks = 0  # made it past the failure point

            # ---- preemption poll, after the completed step, so the
            # emergency checkpoint carries it
            tripped = self.watcher is not None and self.watcher.check()
            if plan is not None and plan.should_fire("preempt", step):
                reg.counter("resilience/faults_injected",
                            kind="preempt").inc()
                if self.watcher is not None:
                    self.watcher.trip("fault-plan")
                else:
                    reg.counter("resilience/preemptions").inc()
                    reg.event("preemption", reason="fault-plan")
                tripped = True
            if tripped:
                reason = (self.watcher.reason or "preempted"
                          if self.watcher is not None else "fault-plan")
                drain_timer = reg.timer("resilience/preempt_drain_s")
                drain_timer.start()
                path = self._emergency_save(state, step)
                reg.event("preempt_exit", step=step, reason=reason,
                          checkpoint=bool(path),
                          duration_s=round(drain_timer.stop(), 6))
                if self.exit_on_preempt:
                    sys.exit(EXIT_PREEMPTED)
                raise Preempted(step, path, reason)

            # ---- periodic checkpoint
            if self.manager is not None and self.save_every and (
                    step % self.save_every == 0
                    or step == num_steps - 1):
                self._save(state, step)

            step += 1

        if self.manager is not None:
            drain_timer = reg.timer("resilience/ckpt_save_s")
            drain_timer.start()
            try:
                self.manager.wait_until_finished()
                drain_timer.stop()
            except Exception as e:  # noqa: BLE001 — the final async
                # commit failing must not cost the trained state
                duration = drain_timer.stop()
                reg.counter("resilience/checkpoint_failures").inc()
                reg.event("checkpoint_failed", step=num_steps - 1,
                          error=repr(e)[:200],
                          duration_s=round(duration, 6))
        return state

    # ------------------------------------------------------- provenance

    def _probe_numerics(self, prev_state, bad_state, step: int):
        """NaN provenance for a failed health check (``loop.py:575``):
        the offending tensor paths and the first non-finite op, from a
        replay on copies (``prev_state`` None: no pre-step values, module
        docstring). Never raises: a broken probe degrades to a message and
        the ladder proceeds on the original error."""
        if not self.numerics_provenance:
            return None
        try:
            prov = nan_probe.step_provenance(self.step_fn, prev_state, bad_state,
                                   step).as_dict()
        except Exception as e:  # noqa: BLE001 - the probe is diagnostics;
            # it must never mask the health failure
            prov = {"ok": False,
                    "message": f"numerics probe failed: {e!r:.200}"}
        reg = self._reg()
        reg.counter("numerics/probes").inc()
        reg.event("numerics_provenance", step=step, **prov)
        return prov

    def _probe_memory(self, error, step: int):
        """OOM forensics for an out-of-memory step death (``loop.py:596``):
        dump a ``memrec_*.json`` post-mortem and return the compact
        verdict (requested bytes, largest live tensor, watermark). None
        for other failures; never raises - the forensics are diagnostics
        and must not mask the step error."""
        if not self.memory_forensics:
            return None
        # classification FIRST, outside the forensics guard: if the
        # memory tier cannot classify, a non-OOM step death must stay a
        # non-OOM step death
        try:
            from apex_tpu_torch.observability.memory import (
                is_oom_error,
                oom_forensics,
            )
        except Exception:  # noqa: BLE001 - no memory tier, no verdict
            return None
        try:
            if not is_oom_error(error):
                return None
        except Exception:  # noqa: BLE001 - cannot classify: not OOM
            return None
        try:
            verdict = oom_forensics(
                error, monitor=self.memory_monitor,
                registry=self._registry, directory=self.directory,
                step=step)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            verdict = {"error": f"memory forensics failed: {e!r:.200}"}
        reg = self._reg()
        reg.counter("memory/oom_probes").inc()
        reg.event("memory_verdict", step=step, **{
            k: v for k, v in verdict.items() if k != "error"})
        return verdict

    # ---------------------------------------------------- fleet desync

    def _check_desync(self, metrics, step: int):
        """Run the desync detector over ``metrics["fleet_fingerprint"]``;
        the verdict dict or None. A broken detector degrades to a counter
        and an event."""
        if self.desync_detector is None or not metrics:
            return None
        gathered = metrics.get("fleet_fingerprint")
        if gathered is None:
            return None
        try:
            return self.desync_detector.check(step, gathered)
        except Exception as e:  # noqa: BLE001 — diagnostics must not
            # fail a healthy step
            reg = self._reg()
            reg.counter("fleet/desync_check_failures").inc()
            reg.event("fleet_desync_check_failed", step=step,
                      error=repr(e)[:200])
            return None

    # --------------------------------------------------------- rollback

    def _rollback(self, fallback_state, fallback_step: int,
                  rollbacks: int, step: int, error, numerics=None,
                  fleet=None, memory=None):
        """Rung 2: restore the newest valid checkpoint in place (or the
        run's starting state) and hand back the replay position. Rung 3:
        past ``max_rollbacks``, abort with the structured report."""
        reg = self._reg()
        rollbacks += 1
        reg.counter("resilience/rollbacks").inc()
        event_fields = {"step": step, "attempt": rollbacks,
                        "error": repr(error)[:200]}
        if numerics is not None:
            event_fields["numerics"] = {
                k: numerics.get(k) for k in
                ("kind", "primitive", "source", "output_paths")}
        if fleet is not None:
            event_fields["fleet"] = {
                k: fleet.get(k) for k in
                ("rank", "tensor_path", "first_divergent_step",
                 "max_delta")}
        if memory is not None:
            event_fields["memory"] = {
                k: memory.get(k) for k in
                ("requested_bytes", "largest_buffer",
                 "watermark_bytes", "memrec")}
        reg.event("rollback", **event_fields)
        if rollbacks > self.max_rollbacks:
            report = {
                "step": step,
                "rollbacks": rollbacks - 1,
                "max_rollbacks": self.max_rollbacks,
                "reason": "rollback budget exhausted",
                "last_error": repr(error)[:500],
                "resumed_from": self.resumed_from,
                "directory": self.directory,
                "counters": {
                    m.name: m.value for m in reg.metrics()
                    if m.kind == "counter"
                    and m.name.startswith("resilience/")},
            }
            if numerics is not None:
                report["numerics"] = numerics
            if fleet is not None:
                report["fleet"] = fleet
            if memory is not None:
                report["memory"] = memory
            reg.event("train_aborted", **report)
            raise TrainAborted(report)
        if self.manager is not None:
            for s in reversed(ckpt.valid_steps(self.directory)):
                restore_timer = reg.timer("resilience/ckpt_restore_s")
                restore_timer.start()
                try:
                    restored = ckpt.restore_checkpoint(
                        self.directory, target={"state": fallback_state},
                        step=s)
                except Exception as e:  # noqa: BLE001
                    duration = restore_timer.stop()
                    reg.counter("resilience/restore_failures").inc()
                    reg.event("restore_failed", step=s,
                              error=repr(e)[:200],
                              duration_s=round(duration, 6))
                    continue
                duration = restore_timer.stop(block_on=restored)
                reg.event("resumed", step=s, rollback=True,
                          duration_s=round(duration, 6))
                return restored["state"], s + 1, rollbacks
        self._restore_start(fallback_state)
        return fallback_state, fallback_step, rollbacks


# -------------------------------------------------------- resume path

def resume_path(step_fn: Callable, *, holds_fallback: bool = True
                ) -> Callable:
    """The loop's post-restore composition as one function
    (``loop.py:737``): ``resume(restored, step) -> (new_state, metrics[,
    restored])``, returning the retained restored reference when
    ``holds_fallback`` (the loop's real behaviour: the fallback state and
    the emergency save still hold it after ``step_fn`` runs)."""

    if holds_fallback:
        def resume(restored, step):
            fallback_state = restored
            new_state, metrics = step_fn(restored, step)
            return new_state, metrics, fallback_state
    else:
        def resume(restored, step):
            return step_fn(restored, step)
    resume.__name__ = f"resume_path({getattr(step_fn, '__name__', 'step')})"
    return resume


# --------------------------------------------------------------- probe

def chaos_probe(spec: str, directory: str, *, steps: int = 24,
                save_every: int = 4, seed: int = 0, max_restarts: int = 8,
                registry=None, device: _device.DeviceLike = None) -> dict:
    """Self-contained chaos smoke (``loop.py:774``): a tiny deterministic
    SGD loop on ``device`` (default: the GPU, raising when there is
    none) run under fault plan ``spec``, restarted on every preemption
    the way a scheduler would (a fresh :class:`FaultPlan` each restart).
    Each step's gradient comes from a ``torch.Generator`` seeded by
    ``(seed, step)``. Returns a summary dict whose counters also land in
    the registry."""
    from apex_tpu_torch.resilience.retry import Policy

    faults_mod.FaultPlan.parse(spec)  # validate before any work
    dev = _device.resolve(device)

    def template():
        return {"w": torch.ones((16, 16), dtype=torch.float32, device=dev)}

    def step_fn(state, step):
        gen = torch.Generator(device=dev).manual_seed(
            (seed << 32) + step)
        g = torch.randn((16, 16), generator=gen, device=dev)
        w = state["w"] - 0.01 * (g + 0.1 * state["w"])
        return {"w": w}, {"loss": torch.mean(w * w).item()}

    restarts = 0
    completed = False
    final = None
    for _ in range(max_restarts + 1):
        loop = ResilientTrainLoop(
            step_fn, directory=directory, save_every=save_every,
            fault_plan=faults_mod.FaultPlan.parse(spec),
            retry_policy=Policy(max_attempts=3, initial_backoff=0.001,
                                retry_on=(OSError,
                                          faults_mod.FaultInjected),
                                sleep=lambda s: None, seed=seed,
                                name="chaos_probe", registry=registry),
            registry=registry)
        try:
            final = loop.run(template(), steps)
            completed = True
            break
        except Preempted:
            restarts += 1
    reg = registry
    if reg is None:
        from apex_tpu_torch.observability import get_registry
        reg = get_registry()
    summary = {"completed": completed, "restarts": restarts,
               "steps": steps, "plan": spec}
    for m in reg.metrics():
        if m.kind == "counter" and m.name.startswith("resilience/"):
            label = ",".join(f"{k}={v}" for k, v in
                             sorted(m.labels.items()))
            summary[m.name + (f"{{{label}}}" if label else "")] = m.value
    if final is not None:
        summary["final_param_sum"] = float(torch.sum(final["w"]))
    reg.event("chaos_probe", **{k: v for k, v in summary.items()
                                if isinstance(v, (int, float, str, bool))})
    return summary
