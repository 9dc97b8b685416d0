"""apex_tpu_torch.serving — continuous-batching inference runtime on the
GPU (port of ``apex_tpu.serving``).

Paged KV cache with a trash page (its budget from the card's memory), a
prefill/decode scheduler over packed slot tensors whose decode step is one
CUDA graph (bf16 or fp8 weights: ``weight_mode``), request telemetry on
the metric registry, and the reference's drain/dump/resume contract for
preempted servers.
"""

from apex_tpu_torch.serving.engine import ServerMetrics, ServingEngine
from apex_tpu_torch.serving.kv_cache import (
    PageAllocator,
    PageBudget,
    PagedKVCache,
    derive_page_budget,
    page_hbm_bytes,
)
from apex_tpu_torch.serving.loadgen import (
    TraceRequest,
    make_trace,
    run_closed_loop,
    run_sequential,
    summarize,
)
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    DecodeGraph,
    Request,
    build_decode_step,
    build_prefill,
    fp8_weight_scales,
    pages_per_request,
)

__all__ = [
    "ContinuousBatchScheduler",
    "DecodeGraph",
    "PageAllocator",
    "PageBudget",
    "PagedKVCache",
    "Request",
    "ServerMetrics",
    "ServingEngine",
    "TraceRequest",
    "build_decode_step",
    "build_prefill",
    "derive_page_budget",
    "fp8_weight_scales",
    "make_trace",
    "page_hbm_bytes",
    "pages_per_request",
    "run_closed_loop",
    "run_sequential",
    "summarize",
]
