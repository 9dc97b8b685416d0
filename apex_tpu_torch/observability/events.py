"""The event-name catalog (port of ``apex_tpu/observability/events.py``,
copied: the two packages emit one vocabulary).

Every ``reg.event(name, ...)`` site must emit a name registered here -
the run ledger (:mod:`apex_tpu_torch.observability.goodput`) parses the
event stream by name, and an unregistered rename would silently drop
its intervals from the goodput accounting.

:data:`EVENT_CATALOG` maps each event name to the tuple of fields the
emitter guarantees on every record (a *minimum* - emitters may add
more). Only the goodput-critical events pin fields beyond the name;
for the rest an empty tuple just reserves the name.

:data:`GOODPUT_CRITICAL` is the subset the ledger's interval
reconstruction depends on: their required fields are load-bearing and
may only grow, never shrink or rename (the same backward-compatible
contract as ``step_report.STEP_RECORD_FIELDS``).
"""

from __future__ import annotations

__all__ = ["EVENT_CATALOG", "GOODPUT_CRITICAL", "DYNAMIC_EVENT_SITES"]

#: event name -> minimum guaranteed fields (empty = name-only
#: reservation). Sorted by subsystem for reviewability.
EVENT_CATALOG = {
    # observability core / step reporting
    "step": ("reporter", "step", "step_time_ms"),
    "tpu_init_error": (),
    # recompile accounting (the retrace budget)
    "retrace_budget_exceeded": ("retraces", "budget"),
    # profiling / flight recorder
    "flight_record": ("path", "reason", "step"),
    "flight_dump_failed": ("reason", "error"),
    # numerics tier
    "numerics_stats": ("source",),
    "numerics_nonfinite": ("source", "step"),
    "numerics_grad_spike": ("source", "step"),
    "numerics_loss_spike": ("source", "step"),
    "numerics_loss_plateau": ("source", "step"),
    "numerics_overflow_streak": ("source", "step"),
    "numerics_provenance": ("step",),
    # amp
    "amp_overflow": (),
    # fleet tier
    "fleet/desync": (),
    "fleet/straggler": (),
    "fleet_desync_check_failed": ("step", "error"),
    # memory tier
    "memory_snapshot": ("source", "step"),
    "memory_dump": ("source",),
    "memory_calibration": ("target",),
    "memory_calibration_skipped": ("target",),
    "memory_record": ("path", "trigger", "step"),
    "memrec_dump_failed": ("error",),
    "memory_verdict": ("step",),
    # tuning
    "tuning_result": ("kernel", "bucket"),
    "kernel_dispatch": ("component", "choice"),
    # auto-shard planner
    "plan": ("model", "devices"),
    "plan_calibration": ("model",),
    # bench harness
    "bench_start": ("platform",),
    "fp8_race": (),
    # resilience: the goodput-critical set + the checkpoint ladder.
    # duration_s stamps are seconds of host wall time spent
    # in the phase the event closes — the ledger's interval source.
    "preemption": ("reason",),
    "preempt_exit": ("step", "reason", "checkpoint", "duration_s"),
    "checkpoint_failed": ("step", "error", "duration_s"),
    "checkpoint_saved": ("step", "duration_s"),
    "emergency_flush_failed": ("step", "error"),
    "emergency_save_failed": ("step", "error", "duration_s"),
    "gc_partial_checkpoints": ("removed", "duration_s"),
    "restore_failed": ("step", "error", "duration_s"),
    "resumed": ("step", "duration_s"),
    "attempt_start": ("start_step", "num_steps", "resumed",
                      "startup_s"),
    "step_done": ("step", "duration_s"),
    "rollback": ("step", "attempt", "error"),
    "train_aborted": ("step", "rollbacks", "reason"),
    "resilience_give_up": ("scope", "attempts"),
    "chaos_probe": ("completed", "restarts", "steps", "plan"),
    # serving: the engine's drain record — queue + in-flight
    # counts at the moment the preemption contract fired
    "serving_drain": ("reason", "iteration", "inflight", "queued",
                      "dump_dir"),
}

#: the events whose required fields the run ledger's interval
#: reconstruction parses (ledger.py keys on exactly these names —
#: renaming one here without updating the ledger is a schema break,
#: which is the point of pinning them).
GOODPUT_CRITICAL = (
    "step", "step_done", "attempt_start", "resumed", "rollback",
    "preempt_exit", "train_aborted", "checkpoint_saved",
    "checkpoint_failed", "gc_partial_checkpoints", "restore_failed",
    "flight_record",
)

#: call sites whose event NAME is computed at runtime (the catalog
#: test cannot resolve a literal there). Each entry maps
#: "module.path:qualified_context" -> the names that site can emit —
#: all of which must still be catalogued above.
DYNAMIC_EVENT_SITES = {
    "apex_tpu_torch/observability/numerics/health.py": (
        "numerics_nonfinite", "numerics_grad_spike",
        "numerics_loss_spike", "numerics_loss_plateau",
        "numerics_overflow_streak",
    ),
}
