"""The preemption exception of the resilient loops (port of
``Preempted``, ``apex_tpu/resilience/loop.py:80``).

The reference's ``ResilientTrainLoop`` (auto-resume, periodic and
emergency checkpoints, the skip -> rollback -> abort ladder) waits for
the checkpoint slice; the serving engine raises :class:`Preempted` today.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.resilience.preemption import EXIT_PREEMPTED

__all__ = ["Preempted"]


class Preempted(RuntimeError):
    """Raised after the emergency dump when preemption tripped.

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
