"""The serving engine: request loop + telemetry (port of
``apex_tpu/serving/engine.py``).

``ServingEngine`` wires :class:`ContinuousBatchScheduler` to llama
weights and publishes the ``serving/*`` metric family on the registry.
The reference's drain -> dump -> exit-75 -> resume contract is not
ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from apex_tpu_torch import _device
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Request,
)

__all__ = ["ServerMetrics", "ServingEngine"]


class ServerMetrics:
    """The ``serving/*`` family: request latency and time-to-first-token
    histograms, lifecycle counters, occupancy/utilization gauges."""

    def __init__(self, registry=None):
        if registry is None:
            from apex_tpu_torch.observability import get_registry
            registry = get_registry()
        self.registry = registry

    def submitted(self) -> None:
        self.registry.counter("serving/requests_submitted").inc()

    def admitted(self) -> None:
        self.registry.counter("serving/requests_admitted").inc()

    def completed(self, req: Request) -> None:
        self.registry.counter("serving/requests_completed").inc()
        self.registry.counter("serving/tokens_generated").inc(
            len(req.tokens))
        if req.submit_s is not None and req.finish_s is not None:
            self.registry.histogram("serving/request_latency_ms").observe(
                (req.finish_s - req.submit_s) * 1e3)
        if req.submit_s is not None and req.first_token_s is not None:
            self.registry.histogram("serving/ttft_ms").observe(
                (req.first_token_s - req.submit_s) * 1e3)

    def step(self, occupancy: float, page_utilization: float) -> None:
        self.registry.gauge("serving/batch_occupancy").set(occupancy)
        self.registry.gauge("serving/page_utilization").set(
            page_utilization)

    def publish_summary(self, summary: dict) -> None:
        """Mirror a loadgen report's scalars as ``serving/*`` gauges."""
        for key in ("latency_p50_ms", "latency_p99_ms", "ttft_p50_ms",
                    "ttft_p99_ms", "tokens_per_s", "mean_occupancy"):
            value = summary.get(key)
            if value is not None:
                self.registry.gauge(f"serving/{key}").set(float(value))


class ServingEngine:
    """Continuous-batching inference server over llama weights.

    ``num_pages`` is required: the reference derives it from memory
    priors calibrated on a TPU, which do not carry over. ``device``
    defaults to the GPU and raises when there is none; the params must
    already live there. ``weight_mode`` is ``"native"`` (or ``"bf16"``)
    or ``"fp8"``: every layer product through the fp8 cast kernel and an
    fp8 GEMM, with static per-layer weight scales computed once here.
    """

    def __init__(self, params, cfg, *, num_pages: int, page_size: int = 8,
                 max_batch: int = 4, max_prompt_len: int = 64,
                 max_new_cap: int = 32, weight_mode: str = "native",
                 eos_id: Optional[int] = None, registry=None,
                 device: _device.DeviceLike = None):
        self.device = _device.resolve(device)
        self.scheduler = ContinuousBatchScheduler(
            params, cfg, num_pages=num_pages, page_size=page_size,
            max_batch=max_batch, max_prompt_len=max_prompt_len,
            max_new_cap=max_new_cap, weight_mode=weight_mode,
            eos_id=eos_id, device=self.device)
        self.metrics = ServerMetrics(registry)
        self.results: Dict[int, dict] = {}
        self.completed: List[Request] = []
        self.iteration = 0
        self._next_rid = 0
        self._occ_sum = 0.0
        self._occ_steps = 0

    # -------------------------------------------------------- requests

    @property
    def pending(self) -> bool:
        return self.scheduler.has_work()

    def submit(self, prompt, max_new_tokens: int,
               rid: Optional[int] = None,
               arrival_s: float = 0.0) -> int:
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid=rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=float(arrival_s),
                      submit_s=time.monotonic())
        self.scheduler.submit(req)
        self.metrics.submitted()
        return rid

    # ------------------------------------------------------------ loop

    def step(self) -> List[Request]:
        """One engine iteration: admit, decode, evict. Returns the
        requests finished this iteration."""
        admitted, finished = self.scheduler.try_admit()
        for _ in admitted:
            self.metrics.admitted()
        occ = self.scheduler.occupancy()
        if self.scheduler.num_active():
            self._occ_sum += occ
            self._occ_steps += 1
        self.metrics.step(occ, self.scheduler.cache.utilization())
        finished = finished + self.scheduler.step_decode()
        for req in finished:
            self._finish(req)
        self.iteration += 1
        return finished

    def run(self, max_iterations: int = 100_000) -> Dict[int, dict]:
        """Drive until the queue and every slot are empty."""
        steps = 0
        while self.pending:
            if steps >= max_iterations:
                raise RuntimeError(
                    f"engine made no exit after {max_iterations} "
                    f"iterations: scheduler wedged?")
            self.step()
            steps += 1
        return self.results

    def mean_occupancy(self) -> float:
        return self._occ_sum / self._occ_steps if self._occ_steps else 0.0

    def _finish(self, req: Request) -> None:
        self.results[req.rid] = {
            "prompt": [int(t) for t in req.prompt],
            "tokens": [int(t) for t in req.tokens],
        }
        self.completed.append(req)
        self.metrics.completed(req)
