"""The serving engine: request loop + telemetry + preemption contract
(port of ``apex_tpu/serving/engine.py``).

``ServingEngine`` wires :class:`ContinuousBatchScheduler` to llama
weights, publishes the ``serving/*`` metric family on the registry, and
keeps the reference's preemption contract for servers: when the watcher
(or a seeded fault plan) trips between iterations, the engine stops
admitting, drains (each decode step ends in a host read of its tokens,
so the in-flight step has landed by the time the flag is polled),
emergency-dumps queue + in-flight cache state, and raises
:class:`~apex_tpu_torch.resilience.loop.Preempted` (exit code 75 via
``exit_on_preempt=True`` for process-level supervisors).
:meth:`ServingEngine.resume` rebuilds from the dump: restored K/V pages
land by scatter, not re-prefill, so every resumed request's remaining
tokens are bit-identical to the uninterrupted run.

The dump layout under ``dump_dir`` is the reference's, and either
package resumes the other's:

- ``kv_pages.npz``: per-request gathered page arrays ``k_<rid>`` /
  ``v_<rid>`` ``[L, n, page_size, nkv, d]`` (written first); float32 as
  it is, bf16 as ``|V2`` items holding its bits
  (:func:`~apex_tpu_torch.serving.kv_cache.dump_array`);
- ``state.json``: schema, engine geometry, queued + in-flight request
  records, completed results (written LAST, atomically: its presence
  marks a complete dump).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from apex_tpu_torch import _device
from apex_tpu_torch.resilience.loop import Preempted
from apex_tpu_torch.resilience.preemption import EXIT_PREEMPTED
from apex_tpu_torch.serving.kv_cache import derive_page_budget, dump_array
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Request,
    pages_per_request,
)

__all__ = ["ServerMetrics", "ServingEngine"]

DUMP_SCHEMA_VERSION = 1
_STATE_FILE = "state.json"
_PAGES_FILE = "kv_pages.npz"

# engine-geometry keys that must survive a dump/resume round trip:
# identical shapes => identical reduction trees => bit-identical tokens
_GEOMETRY_KEYS = ("page_size", "max_batch", "num_pages",
                  "max_prompt_len", "max_new_cap", "weight_mode",
                  "eos_id")


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

    def preempted(self, n_outstanding: int) -> None:
        self.registry.counter("serving/requests_preempted").inc(
            n_outstanding)

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

    ``num_pages=None`` derives the page budget from the card's memory
    (:func:`~apex_tpu_torch.serving.kv_cache.derive_page_budget`, kept as
    :attr:`page_budget`), capped at what ``max_batch`` concurrent
    worst-case requests can ever use: the budget bounds the cache, the
    workload bounds the budget. ``device`` defaults to the GPU and raises
    when there is none; the params must already live there.
    ``weight_mode`` is ``"native"`` (or ``"bf16"``) or ``"fp8"``: every
    layer product through the fp8 cast kernel and an fp8 GEMM, with
    static per-layer weight scales computed once here.
    """

    def __init__(self, params, cfg, *, page_size: int = 8,
                 max_batch: int = 4, num_pages: Optional[int] = None,
                 max_prompt_len: int = 64, max_new_cap: int = 32,
                 weight_mode: str = "native",
                 eos_id: Optional[int] = None,
                 watcher=None, fault_plan=None, registry=None,
                 dump_dir: Optional[str] = None,
                 exit_on_preempt: bool = False,
                 hbm_safety: float = 0.90,
                 device: _device.DeviceLike = None):
        self.device = _device.resolve(device)
        self.page_budget = None
        one = pages_per_request(max_prompt_len, max_new_cap, page_size)
        if num_pages is None:
            self.page_budget = derive_page_budget(
                cfg, page_size, safety=hbm_safety, device=self.device)
            num_pages = min(self.page_budget.pages, max_batch * one)
            if num_pages < one:
                raise ValueError(
                    f"page budget {self.page_budget.pages} cannot hold one "
                    f"worst-case request ({one} pages): lower "
                    f"max_prompt_len/max_new_cap or free device memory "
                    f"(budget: {self.page_budget})")
        self.scheduler = ContinuousBatchScheduler(
            params, cfg, num_pages=num_pages, page_size=page_size,
            max_batch=max_batch, max_prompt_len=max_prompt_len,
            max_new_cap=max_new_cap, weight_mode=weight_mode,
            eos_id=eos_id, device=self.device)
        self.metrics = ServerMetrics(registry)
        self.watcher = watcher
        self.fault_plan = fault_plan
        self.dump_dir = dump_dir
        self.exit_on_preempt = exit_on_preempt
        self.results: Dict[int, dict] = {}
        self.completed: List[Request] = []
        self.iteration = 0
        self.draining = False
        self._next_rid = 0
        self._occ_sum = 0.0
        self._occ_steps = 0
        self._config = {
            "page_size": page_size, "max_batch": max_batch,
            "num_pages": num_pages, "max_prompt_len": max_prompt_len,
            "max_new_cap": max_new_cap,
            "weight_mode": self.scheduler.weight_mode,
            "eos_id": eos_id,
        }

    # -------------------------------------------------------- requests

    @property
    def pending(self) -> bool:
        return self.scheduler.has_work()

    def submit(self, prompt, max_new_tokens: int,
               rid: Optional[int] = None,
               arrival_s: float = 0.0) -> int:
        if self.draining:
            raise RuntimeError("engine is draining; not admitting")
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
        """One engine iteration: poll preemption, admit, decode, evict.
        Returns the requests finished this iteration."""
        self._poll_preemption()
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

    def run(self, max_iterations: int = 100_000,
            retrace_guard: bool = True) -> Dict[int, dict]:
        """Drive until the queue and every slot are empty. The retrace
        guard is the reference's acceptance contract (``engine.py:204``):
        the decode graph is captured once, whatever batch compositions
        occurred."""
        steps = 0
        while self.pending:
            if steps >= max_iterations:
                raise RuntimeError(
                    f"engine made no exit after {max_iterations} "
                    f"iterations: scheduler wedged?")
            self.step()
            steps += 1
        if retrace_guard:
            retraces = self.scheduler.decode_retraces()
            if retraces:
                raise RuntimeError(
                    f"decode step captured again {retraces}x in steady "
                    f"state: batch composition leaked into shapes")
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

    # ------------------------------------------------------ preemption

    def _poll_preemption(self) -> None:
        reason = None
        if (self.fault_plan is not None
                and self.fault_plan.should_fire("preempt",
                                                self.iteration)):
            reason = f"fault-plan preempt@{self.iteration}"
        if (reason is None and self.watcher is not None
                and self.watcher.check()):
            reason = self.watcher.reason or "preempted"
        if reason is not None:
            self._drain(reason)

    def _drain(self, reason: str) -> None:
        """The server drain: stop admitting (the in-flight decode step
        has landed: its tokens were read on the host), dump, exit."""
        self.draining = True
        queued, inflight, arrays = self.scheduler.export_requests()
        path = self.dump_dir
        if path is not None:
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, _PAGES_FILE),
                     **{name: dump_array(t) for name, t in arrays.items()})
            state = {
                "schema_version": DUMP_SCHEMA_VERSION,
                "iteration": self.iteration,
                "reason": reason,
                "next_rid": self._next_rid,
                "engine": dict(self._config),
                "queued": queued,
                "inflight": inflight,
                "completed": {str(rid): res
                              for rid, res in self.results.items()},
            }
            tmp = os.path.join(path, _STATE_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump(state, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(path, _STATE_FILE))
        self.metrics.preempted(len(queued) + len(inflight))
        self.metrics.registry.event(
            "serving_drain", reason=reason, iteration=self.iteration,
            inflight=len(inflight), queued=len(queued),
            dump_dir=path or "")
        if self.exit_on_preempt:
            sys.exit(EXIT_PREEMPTED)
        raise Preempted(self.iteration, path, reason)

    # ---------------------------------------------------------- resume

    @classmethod
    def resume(cls, dump_dir: str, params, cfg,
               **overrides) -> "ServingEngine":
        """Rebuild an engine from an emergency dump of either package.
        Geometry defaults to the dumped engine's (same shapes ->
        bit-identical remaining tokens); runtime wiring (watcher,
        fault_plan, registry, dump_dir, exit_on_preempt, device) comes
        from ``overrides``."""
        with open(os.path.join(dump_dir, _STATE_FILE)) as f:
            state = json.load(f)
        if state.get("schema_version") != DUMP_SCHEMA_VERSION:
            raise ValueError(
                f"serving dump at {dump_dir} has schema_version "
                f"{state.get('schema_version')}; this engine reads "
                f"[{DUMP_SCHEMA_VERSION}]")
        kw = {k: state["engine"][k] for k in _GEOMETRY_KEYS}
        kw.setdefault("dump_dir", dump_dir)
        kw.update(overrides)
        engine = cls(params, cfg, **kw)
        engine.iteration = state["iteration"]
        engine._next_rid = state["next_rid"]
        engine.results = {int(rid): res
                          for rid, res in state["completed"].items()}
        pages_path = os.path.join(dump_dir, _PAGES_FILE)
        with np.load(pages_path) as pages:
            for rec in state["inflight"]:
                engine.scheduler.import_request(
                    rec, pages[f"k_{rec['rid']}"],
                    pages[f"v_{rec['rid']}"])
                engine.metrics.submitted()
                engine.metrics.admitted()
        for rec in state["queued"]:
            engine.submit(rec["prompt"], rec["max_new_tokens"],
                          rid=rec["rid"],
                          arrival_s=rec.get("arrival_s", 0.0))
        return engine
