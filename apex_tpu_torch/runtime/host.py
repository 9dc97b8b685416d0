"""Host runtime (port of ``apex_tpu/runtime/host.py``): the
gradient-bucket planner (``plan_buckets`` :118, ``bucket_offsets`` :140)
and the prefetching input loader (``PrefetchLoader`` :243).

The reference runs these in its native host library
(``csrc/host_runtime.cpp``) when it is built and in pure Python
otherwise; the port never loads that library. The planner is the same
reverse-order greedy, so its plans equal the reference's.
:class:`PrefetchLoader` is threads only: ``n_workers`` Python threads
fill the batches (numpy's generators and large array operations release
the GIL), as the native ring's workers do; the reference's Python
fallback uses one thread.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence, Tuple

import numpy as np


def plan_buckets(sizes: Sequence[int], bucket_bytes: int) -> List[int]:
    """Bucket id of each tensor, greedy in reverse order (gradients
    become ready in about the reverse of the parameter order): a bucket
    closes when the next tensor would take it past ``bucket_bytes``; a
    tensor larger than the cap has a bucket of its own."""
    out = [0] * len(sizes)
    bucket, used = 0, 0
    for i in range(len(sizes) - 1, -1, -1):
        if used > 0 and used + sizes[i] > bucket_bytes:
            bucket += 1
            used = 0
        out[i] = bucket
        used += sizes[i]
    return out


def bucket_offsets(sizes: Sequence[int], bucket_ids: Sequence[int]
                   ) -> Tuple[List[int], List[int]]:
    """(each tensor's offset within its bucket, each bucket's total
    size)."""
    n_buckets = (max(bucket_ids) + 1) if bucket_ids else 0
    used = [0] * n_buckets
    offs = [0] * len(sizes)
    for i, size in enumerate(sizes):
        offs[i] = used[bucket_ids[i]]
        used[bucket_ids[i]] += size
    return offs, used


class _Failed:
    """A fill that raised, in the slot of its batch."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Threaded prefetch over a ``fill(batch_idx, out_array)`` callback
    (``host.py:243``). Iterating yields numpy arrays of ``batch_shape``
    and ``dtype`` in batch order while up to ``n_slots`` batches (being
    filled, or filled and not yet taken) are in flight on ``n_workers``
    threads: the input-pipeline overlap of DataLoader workers.

    Shutdown contract: closing or abandoning the iterator stops the
    workers and joins them before it returns (a fill in progress runs to
    its end; no new one starts); a worker never waits on a full set of
    slots after the consumer has gone; a fill that raises surfaces as
    ``RuntimeError`` on the consuming thread when it reaches that batch,
    never as a hang."""

    def __init__(self, fill: Callable[[int, np.ndarray], None],
                 total_batches: int, batch_shape, dtype=np.float32,
                 n_slots: int = 4, n_workers: int = 2):
        if n_slots < 1 or n_workers < 1:
            raise ValueError(f"n_slots ({n_slots}) and n_workers "
                             f"({n_workers}) must be at least 1")
        self.fill = fill
        self.total = total_batches
        self.shape = tuple(batch_shape)
        self.dtype = np.dtype(dtype)
        self.nbytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.n_slots = n_slots
        self.n_workers = n_workers

    def __iter__(self):
        cond = threading.Condition()
        ready: dict = {}
        # the next batch to claim, the batches taken, and the stop flag
        state = {"next": 0, "taken": 0, "stop": False}

        def claim():
            with cond:
                while not state["stop"] and state["next"] < self.total and \
                        state["next"] - state["taken"] >= self.n_slots:
                    cond.wait()
                if state["stop"] or state["next"] >= self.total:
                    return None
                state["next"] += 1
                return state["next"] - 1

        def worker():
            while True:
                b = claim()
                if b is None:
                    return
                out = np.empty(self.shape, self.dtype)
                try:
                    self.fill(b, out)
                except BaseException as exc:  # noqa: BLE001 — surfaces on
                    # the consumer, which would otherwise wait forever
                    out = _Failed(exc)
                with cond:
                    ready[b] = out
                    cond.notify_all()
                if isinstance(out, _Failed):
                    return

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"apex-prefetch-fill-{i}")
                   for i in range(min(self.n_workers, max(self.total, 1)))]
        for t in threads:
            t.start()
        try:
            for b in range(self.total):
                with cond:
                    while b not in ready:
                        cond.wait()
                    item = ready.pop(b)
                    state["taken"] = b + 1
                    cond.notify_all()
                if isinstance(item, _Failed):
                    raise RuntimeError("prefetch fill callback failed") \
                        from item.exc
                yield item
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()
            for t in threads:
                t.join()
