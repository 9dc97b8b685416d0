"""Host runtime (counterpart of ``apex_tpu.runtime``): the
gradient-bucket planner that data parallelism needs and the prefetching
input loader. The reference's native flatten/prefetch library is not
loaded (its loader is threads only here), and its timing helpers wait
for ROADMAP.md Queue 1 item 7."""

from apex_tpu_torch.runtime.host import (
    PrefetchLoader,
    bucket_offsets,
    plan_buckets,
)

__all__ = ["PrefetchLoader", "bucket_offsets", "plan_buckets"]
