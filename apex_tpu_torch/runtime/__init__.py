"""Host runtime (counterpart of ``apex_tpu.runtime``): so far the
gradient-bucket planner that data parallelism needs. The rest of the
reference's host runtime (its native flatten/prefetch library, the
timing helpers) waits for ROADMAP.md Queue 1 item 7."""

from apex_tpu_torch.runtime.host import bucket_offsets, plan_buckets

__all__ = ["bucket_offsets", "plan_buckets"]
