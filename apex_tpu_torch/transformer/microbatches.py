"""Number-of-microbatches calculators (port of
``apex_tpu/transformer/microbatches.py``).

Pure host-side bookkeeping: it feeds the pipeline schedule's loop
bounds, so it is Python ints.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from apex_tpu_torch.transformer.utils import divide


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """ref microbatches.py:26 — pick constant vs rampup calculator."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size must be [start_batch_size, increment, "
            f"ramp-up samples], got {rampup_batch_size}"
        )
    start, incr, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start,
        incr,
        samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    )


class NumMicroBatchesCalculator(ABC):
    """ref microbatches.py:77."""

    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    @abstractmethod
    def update(self, consumed_samples, consistency_check) -> None:
        ...


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """ref microbatches.py:93."""

    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.num_micro_batches = divide(global_batch_size, micro_batch_times_dp)
        if self.num_micro_batches < 1:
            raise ValueError("global batch smaller than one microbatch per replica")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check) -> None:
        del consumed_samples, consistency_check


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear batch-size ramp-up (ref microbatches.py:112)."""

    def __init__(
        self,
        start_batch_size,
        batch_size_increment,
        ramup_samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    ):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size

        diff = global_batch_size - start_batch_size
        if diff < 0:
            raise ValueError(
                "global batch size must be ≥ start batch size for ramp-up"
            )
        if diff % batch_size_increment != 0:
            raise ValueError(
                "(global - start) batch size must be divisible by the increment"
            )
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0 else 0
        )
        self.update(0, False)

    def update(self, consumed_samples, consistency_check) -> None:
        if (
            consumed_samples > self.ramup_samples
            or self.rampup_samples_per_increment == 0
        ):
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size
            )
        if consistency_check:
            divide(
                self.current_global_batch_size,
                self.micro_batch_times_data_parallel_size,
            )
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size
        )
