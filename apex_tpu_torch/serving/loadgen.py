"""Seeded synthetic traffic + the closed-loop driver (port of
``apex_tpu/serving/loadgen.py``).

:func:`make_trace` draws the same deterministic trace as the reference
for a given seed (numpy's ``RandomState``), so both packages can serve
the identical workload. :func:`run_closed_loop` drives a
:class:`ServingEngine` over a trace and reports p50/p99 request latency,
ttft p50/p99, tokens/s and mean batch occupancy; :func:`run_sequential`
is the one-request-at-a-time ``generate()`` baseline.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from apex_tpu_torch import _device

__all__ = [
    "TraceRequest",
    "make_trace",
    "run_closed_loop",
    "run_sequential",
    "summarize",
]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int


def make_trace(*, seed: int = 0, num_requests: int = 8,
               arrival_rate_hz: float = 50.0,
               prompt_lens: Sequence[int] = (4, 8, 12, 24),
               output_lens: Sequence[int] = (4, 8, 16),
               vocab_size: int = 256) -> List[TraceRequest]:
    """A deterministic Poisson trace (same seed -> same trace, token for
    token, as the reference's)."""
    if num_requests < 1 or arrival_rate_hz <= 0:
        raise ValueError("need num_requests >= 1 and a positive "
                         "arrival rate")
    rng = np.random.RandomState(seed)
    t = 0.0
    trace = []
    for rid in range(num_requests):
        t += float(rng.exponential(1.0 / arrival_rate_hz))
        p = int(rng.choice(list(prompt_lens)))
        max_new = int(rng.choice(list(output_lens)))
        prompt = rng.randint(0, vocab_size, size=p).astype(np.int32)
        trace.append(TraceRequest(rid=rid, arrival_s=t, prompt=prompt,
                                  max_new_tokens=max_new))
    return trace


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def summarize(engine, wall_s: float) -> dict:
    """The serving report from an engine's completed requests."""
    reqs = engine.completed
    lats = [(r.finish_s - r.submit_s) * 1e3 for r in reqs
            if r.finish_s is not None and r.submit_s is not None]
    ttfts = [(r.first_token_s - r.submit_s) * 1e3 for r in reqs
             if r.first_token_s is not None and r.submit_s is not None]
    tokens = sum(len(r.tokens) for r in reqs)
    report = {
        "requests": len(reqs),
        "tokens": tokens,
        "wall_s": wall_s,
        "tokens_per_s": tokens / wall_s if wall_s > 0 else 0.0,
        "mean_occupancy": engine.mean_occupancy(),
        "decode_steps": engine.scheduler.decode_steps,
        "prefills": engine.scheduler.prefill_count,
        "decode_retraces": engine.scheduler.decode_retraces(),
    }
    if lats:
        report["latency_p50_ms"] = _percentile(lats, 50)
        report["latency_p99_ms"] = _percentile(lats, 99)
    if ttfts:
        report["ttft_p50_ms"] = _percentile(ttfts, 50)
        report["ttft_p99_ms"] = _percentile(ttfts, 99)
    return report


def run_closed_loop(engine, trace: List[TraceRequest], *,
                    use_wall_clock: bool = True,
                    publish: bool = True) -> dict:
    """Drive ``engine`` over ``trace`` to completion and report.

    ``use_wall_clock=True`` injects each request when real time passes
    its arrival offset; ``use_wall_clock=False`` submits everything up
    front (deterministic scheduling). ``publish`` mirrors the report as
    ``serving/*`` gauges on the engine's registry.
    """
    pending = collections.deque(
        sorted(trace, key=lambda t: (t.arrival_s, t.rid)))
    start = time.monotonic()
    while pending or engine.pending:
        now = time.monotonic() - start
        while pending and (not use_wall_clock
                           or pending[0].arrival_s <= now):
            tr = pending.popleft()
            engine.submit(tr.prompt, tr.max_new_tokens, rid=tr.rid,
                          arrival_s=tr.arrival_s)
        if engine.pending:
            engine.step()
        elif pending:
            # idle until the next arrival: nothing to decode
            time.sleep(max(0.0, min(
                0.01, pending[0].arrival_s - (time.monotonic() - start))))
    wall = time.monotonic() - start
    report = summarize(engine, wall)
    if publish:
        engine.metrics.publish_summary(report)
    return report


def run_sequential(params, cfg, trace: List[TraceRequest],
                   device=None) -> dict:
    """The no-batching baseline: each request runs alone through
    ``models.generate.generate`` (greedy)."""
    from apex_tpu_torch.models.generate import generate

    device = _device.resolve(device)
    start = time.monotonic()
    tokens = 0
    results = {}
    for tr in trace:
        prompt = torch.from_numpy(tr.prompt.astype(np.int64))[None, :]
        out = generate(params, prompt, cfg, tr.max_new_tokens,
                       device=device)
        out = out.cpu().numpy()  # the request is done when read
        results[tr.rid] = [int(t) for t in out[0, len(tr.prompt):]]
        tokens += tr.max_new_tokens
    wall = time.monotonic() - start
    return {
        "requests": len(trace),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "results": results,
    }
