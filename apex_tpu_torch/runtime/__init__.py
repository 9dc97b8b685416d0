"""Host runtime (counterpart of ``apex_tpu.runtime``): the
gradient-bucket planner that data parallelism needs and the prefetching
input loader, and ``timing``, the device timing helpers (CUDA events
on the card). The reference's native flatten/prefetch library is not
loaded (its loader is threads only here)."""

from apex_tpu_torch.runtime import timing
from apex_tpu_torch.runtime.host import (
    PrefetchLoader,
    bucket_offsets,
    plan_buckets,
)

__all__ = ["PrefetchLoader", "bucket_offsets", "plan_buckets", "timing"]
