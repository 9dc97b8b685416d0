"""Megatron-style batch samplers for dynamic and ramp-up batch sizes
(port of ``apex_tpu/transformer/_data/_batchsampler.py``, Apex's
``MegatronPretrainingSampler`` and ``MegatronPretrainingRandomSampler``).

Index generation is pure numpy and runs nothing on the card, so the port
keeps its own copy of the reference's: the same arguments give the same
index stream, the padded tail and ``with_validity`` included. Each
sampler yields one data-parallel rank's local minibatches of indices
(``global_batch // dp_size``) and resumes from ``consumed_samples``.
"""

from __future__ import annotations

import abc

import numpy as np

__all__ = [
    "MegatronPretrainingSampler",
    "MegatronPretrainingRandomSampler",
]


class _Base(abc.ABC):
    """Base class for Megatron-style batch samplers (ref _batchsampler.py:16)."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def __iter__(self):
        ...

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_size: int) -> None:
        self._local_minibatch_size = new_size
        self.local_minibatch_times_data_parallel_size = (
            new_size * self.data_parallel_size)


def _check_args(total_samples, local_minibatch_size, data_parallel_rank,
                data_parallel_size):
    if total_samples <= 0:
        raise ValueError(f"no sample to consume: {total_samples}")
    if local_minibatch_size <= 0:
        raise ValueError(
            f"local minibatch size must be greater than 0: "
            f"{local_minibatch_size}")
    if data_parallel_size <= 0:
        raise ValueError(
            f"data parallel size must be greater than 0: "
            f"{data_parallel_size}")
    if data_parallel_rank >= data_parallel_size:
        raise ValueError(
            f"data_parallel_rank should be smaller than data parallel size: "
            f"{data_parallel_rank}, {data_parallel_size}")


class MegatronPretrainingSampler(_Base):
    """Sequential sampler (ref _batchsampler.py:38-100).

    Walks ``[consumed_samples, total_samples)`` in order, accumulating one
    *global* minibatch (``local_minibatch_size * data_parallel_size``) at a
    time and yielding this rank's slice of it. (The reference accumulates
    only ``local_minibatch_size`` before slicing — ref _batchsampler.py:88-93
    — which hands every rank > 0 an empty slice; we follow the upstream
    Megatron-LM semantics the reference's docstring points at instead.)

    .. warning:: With ``drop_last=False``, a final tail shorter than
       ``data_parallel_size`` is padded by REPEATING the last sample index
       so every rank stays non-empty (an empty per-rank batch kills SPMD
       consumers). Eval/metric loops that must not double-count the
       repeated sample should pass ``with_validity=True``, which makes the
       sampler yield ``(indices, valid)`` pairs where ``valid`` is a
       boolean list marking padding entries ``False``.
    """

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True,
                 with_validity: bool = False):
        _check_args(total_samples, local_minibatch_size, data_parallel_rank,
                    data_parallel_size)
        if consumed_samples >= total_samples:
            raise ValueError(
                f"no samples left to consume: {consumed_samples}, "
                f"{total_samples}")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        self.drop_last = drop_last
        self.with_validity = with_validity

    def __len__(self) -> int:
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def _emit(self, indices, valid=None):
        if self.with_validity:
            return indices, ([True] * len(indices) if valid is None
                             else valid)
        return indices

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.local_minibatch_times_data_parallel_size:
                start, end = self.get_start_end_idx()
                yield self._emit(batch[start:end])
                batch = []
        if batch and not self.drop_last:
            # split the short tail evenly (sizes differ by at most 1) instead
            # of the reference's fixed-offset slice, which hands every rank
            # past the remainder an empty list (ref _batchsampler.py:97-100);
            # consumers must still expect a ragged final batch. A tail with
            # fewer samples than ranks is padded by REPEATING the last index
            # so drop_last=False keeps its contract (every sample yielded,
            # every rank non-empty) — an empty batch kills SPMD consumers.
            # with_validity=True marks those repeats False (class warning).
            n_real = len(batch)
            if len(batch) < self.data_parallel_size:
                batch = batch + [batch[-1]] * (
                    self.data_parallel_size - len(batch))
            valid = [True] * n_real + [False] * (len(batch) - n_real)
            base, rem = divmod(len(batch), self.data_parallel_size)
            r = self.data_parallel_rank
            start = r * base + min(r, rem)
            end = start + base + (1 if r < rem else 0)
            yield self._emit(batch[start:end], valid[start:end])


class MegatronPretrainingRandomSampler(_Base):
    """Per-epoch-shuffled sampler (ref _batchsampler.py:103-181).

    Each rank owns a contiguous bucket of ``total // (local_mb * dp)``
    ``local_minibatch_size``-sized groups; the bucket is shuffled with a
    generator seeded by the epoch number so every rank (and every resume
    from ``consumed_samples``) sees the same permutation. Incomplete
    trailing batches are dropped.
    """

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int):
        _check_args(total_samples, local_minibatch_size, data_parallel_rank,
                    data_parallel_size)
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        if total_samples < self.local_minibatch_times_data_parallel_size:
            raise ValueError(
                f"total_samples ({total_samples}) must be >= one global "
                f"minibatch (local_minibatch_size * data_parallel_size = "
                f"{self.local_minibatch_times_data_parallel_size})")
        self.last_batch_size = (
            self.total_samples % self.local_minibatch_times_data_parallel_size)

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples

        bucket_size = (
            self.total_samples // self.local_minibatch_times_data_parallel_size
        ) * self.local_minibatch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        rng = np.random.Generator(np.random.PCG64(self.epoch))
        random_idx = rng.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += (
                    self.local_minibatch_times_data_parallel_size)
                yield batch
                batch = []
