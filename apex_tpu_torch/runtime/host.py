"""The gradient-bucket planner (port of ``apex_tpu/runtime/host.py``
``plan_buckets`` :118 and ``bucket_offsets`` :140).

The reference runs these in its native host library when it is built and
in pure Python otherwise; the port keeps the pure-Python version only,
the same reverse-order greedy, so its plans equal the reference's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


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
