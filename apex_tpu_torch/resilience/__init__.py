"""apex_tpu_torch.resilience: fault injection and preemption handling
(port of ``apex_tpu.resilience``, the pieces the serving engine uses).

- :mod:`~apex_tpu_torch.resilience.faults`: :class:`FaultPlan`, seeded
  schedules of preemptions and other faults, the reference's spec
  language and draws.
- :mod:`~apex_tpu_torch.resilience.preemption`:
  :class:`PreemptionWatcher`, SIGTERM + pluggable sensors behind one
  thread-safe flag; :data:`EXIT_PREEMPTED` (75) is the resumable exit
  code.
- :mod:`~apex_tpu_torch.resilience.loop`: :class:`Preempted`.

The reference's ``corrupt_tree``, ``inject_checkpoint_failures``,
``retry`` (``Policy``, ``Deadline``) and ``ResilientTrainLoop`` wait for
the checkpoint slice.
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
)
from apex_tpu_torch.resilience.loop import Preempted  # noqa: F401
from apex_tpu_torch.resilience.preemption import (  # noqa: F401
    EXIT_PREEMPTED,
    PreemptionWatcher,
    env_sensor,
    file_sensor,
)

__all__ = [
    "KINDS", "FaultPlan", "FaultInjected", "TornWrite", "DiskFull",
    "TransientStepError", "InjectedOom", "INJECTED_OOM_BYTES",
    "PreemptionWatcher", "env_sensor", "file_sensor", "EXIT_PREEMPTED",
    "Preempted",
]
