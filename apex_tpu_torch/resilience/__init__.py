"""apex_tpu_torch.resilience: fault injection, preemption handling and
the auto-resuming training loop (port of ``apex_tpu.resilience``).

- :mod:`~apex_tpu_torch.resilience.faults`: :class:`FaultPlan`, seeded
  schedules of preemptions, torn and disk-full checkpoint writes,
  transient step exceptions, NaN storms, stalls and OOMs, in the
  reference's spec language and with the reference's draws;
  :func:`corrupt_tree` and :func:`inject_checkpoint_failures`.
- :mod:`~apex_tpu_torch.resilience.retry`: :class:`Policy` and
  :class:`Deadline`, backoff with jitter and attempt, per-class and
  wall-clock budgets.
- :mod:`~apex_tpu_torch.resilience.preemption`:
  :class:`PreemptionWatcher`, SIGTERM + pluggable sensors behind one
  thread-safe flag; :data:`EXIT_PREEMPTED` (75) is the resumable exit
  code.
- :mod:`~apex_tpu_torch.resilience.loop`: :class:`ResilientTrainLoop`,
  auto-resume from the newest valid checkpoint, periodic and emergency
  saves, and the skip -> rollback -> abort ladder.
"""

from apex_tpu_torch.resilience.faults import (  # noqa: F401
    INJECTED_OOM_BYTES,
    KINDS,
    DiskFull,
    FaultInjected,
    FaultPlan,
    InjectedOom,
    TornWrite,
    TransientStepError,
    corrupt_tree,
    inject_checkpoint_failures,
)
from apex_tpu_torch.resilience.loop import (  # noqa: F401
    Preempted,
    ResilientTrainLoop,
    TrainAborted,
    chaos_probe,
    resume_path,
)
from apex_tpu_torch.resilience.preemption import (  # noqa: F401
    EXIT_PREEMPTED,
    PreemptionWatcher,
    env_sensor,
    file_sensor,
)
from apex_tpu_torch.resilience.retry import (  # noqa: F401
    DEFAULT_RETRYABLE,
    Deadline,
    Policy,
)

__all__ = [
    "KINDS", "FaultPlan", "FaultInjected", "TornWrite", "DiskFull",
    "TransientStepError", "InjectedOom", "INJECTED_OOM_BYTES",
    "corrupt_tree", "inject_checkpoint_failures",
    "Policy", "Deadline", "DEFAULT_RETRYABLE",
    "PreemptionWatcher", "env_sensor", "file_sensor", "EXIT_PREEMPTED",
    "ResilientTrainLoop", "Preempted", "TrainAborted", "chaos_probe",
    "resume_path",
]
