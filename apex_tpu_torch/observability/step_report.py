"""StepReporter - one training step, one structured record (port of
``apex_tpu/observability/step_report.py``).

The per-step evidence format every training example emits: step time,
tokens/s, achieved FLOP/s and MFU (the PaLM-appendix accounting), loss,
loss-scale value and cumulative overflow count from the amp scaler's
state, grad norm, plus free-form extras. Records land in the registry's
event stream (so one ``dump()`` carries metrics AND the step log) and in
registry metrics (``<name>/step_time_ms`` histogram, ``<name>/steps``
counter, ``<name>/loss`` gauge).

MFU is stated against the card's published dense bf16 peak
(:data:`PEAK_FLOPS_BY_KIND`, keyed by a substring of
``torch.cuda.get_device_name()``); an unknown device has no peak and its
records carry ``mfu`` null, never a guess. A computed MFU > 1 is
physically impossible and means the timing failed to wait for the
device: the record then carries ``mfu_suspect``.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.observability.registry import MetricRegistry, get_registry

__all__ = [
    "PEAK_FLOPS_BY_KIND", "peak_flops", "transformer_step_flops",
    "StepReporter", "STEP_RECORD_FIELDS",
]

# Dense bf16 peak FLOP/s by card (a lower-case substring of
# torch.cuda.get_device_name()): the H100 SXM's 989 TFLOP/s from
# NVIDIA's H100 data sheet (without sparsity). A card may run below its
# 700 W maximum power limit, and slower: write the limit beside any MFU.
PEAK_FLOPS_BY_KIND = (
    ("h100", 989e12),
)


def peak_flops(device_kind: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s for a ``torch.cuda.get_device_name()``
    string (substring match), or None for unknown devices and the CPU."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_FLOPS_BY_KIND:
        if key in kind:
            return peak
    return None


def transformer_step_flops(n_params: int, n_layers: int, hidden: int,
                           seq: int, batch: int) -> int:
    """fwd+bwd FLOPs of one decoder train step: ``B·S·(6N + 12·L·h·S)``
    (PaLM appendix accounting — 6N for the parameter matmuls fwd+bwd,
    the second term for attention score/value matmuls)."""
    return batch * seq * (6 * n_params + 12 * n_layers * hidden * seq)


# Fields every step record carries (None when the caller didn't supply
# the ingredient) - the reference's tuple, so the schema is one across
# the packages. ``numerics`` is the latest decimated stats-pass summary
# (``numerics.StatsCollector.last`` - finite flag, non-finite paths,
# top-k amax tensors, stats-pass cost). ``memory`` is the latest
# decimated live-memory snapshot (``memory.MemoryMonitor.last`` - live
# bytes, watermark, top-k tensors, snapshot cost). ``process_index`` /
# ``process_count`` are the fleet stamp (0 / 1 for a solo process);
# ``run_id`` rides as an extra field only when set.
STEP_RECORD_FIELDS = (
    "reporter", "step", "step_time_ms", "loss", "loss_scale",
    "overflow_count", "grad_norm", "tokens_per_sec", "tflops_per_sec",
    "mfu", "numerics", "memory", "process_index", "process_count",
)


def _host_float(value):
    """Pull a scalar (Python/numpy/0-d tensor) to a host float, or
    None."""
    if value is None:
        return None
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return float(value.item())
        except Exception:  # noqa: BLE001 — non-scalar handed in
            return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class StepReporter:
    """Turns one timed training step into a structured record.

    ``tokens_per_step`` and ``flops_per_step`` parameterize the
    throughput/MFU derivation (use :func:`transformer_step_flops`);
    ``peak`` overrides the device lookup. ``device_kind`` defaults to
    ``torch.cuda.get_device_name()`` when a card is present, else None
    (no peak, ``mfu`` null).
    """

    def __init__(self, name: str, registry: Optional[MetricRegistry] = None,
                 tokens_per_step: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 device_kind: Optional[str] = None,
                 peak: Optional[float] = None):
        self.name = name
        self.registry = registry if registry is not None else get_registry()
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        if device_kind is None:
            import torch

            if torch.cuda.is_available():
                device_kind = torch.cuda.get_device_name()
        self.device_kind = device_kind
        self.peak = peak if peak is not None else (
            peak_flops(device_kind) if device_kind else None)
        self.records: list = []

    def step(self, step_time_s: float, *, loss=None, scaler_state=None,
             grad_norm=None, numerics=None, memory=None,
             **extra) -> dict:
        """Record one step; returns the record's ``fields`` dict.

        ``scaler_state``: an ``amp.scaler.LossScaleState`` (or anything
        with ``loss_scale``/``overflows`` attrs) — the loss-scale value
        and cumulative overflow count are host-read from it.
        ``numerics``: the latest stats-pass summary dict
        (``numerics.StatsCollector.last``) — attach it every step; the
        collector only refreshes it on its decimated cadence, so the
        record says which stats window it was inside.
        ``memory``: the latest live-memory snapshot dict
        (``memory.MemoryMonitor.last``) — same decimated-cadence
        contract as ``numerics``.
        """
        from apex_tpu_torch.observability.fleet.identity import (
            process_identity,
        )

        step_time_s = float(step_time_s)
        if step_time_s <= 0:
            raise ValueError(f"step_time_s must be positive, "
                             f"got {step_time_s}")
        ident = process_identity()
        fields = {
            "reporter": self.name,
            "step": len(self.records),
            "step_time_ms": round(step_time_s * 1e3, 3),
            "loss": _host_float(loss),
            "loss_scale": None,
            "overflow_count": None,
            "grad_norm": _host_float(grad_norm),
            "tokens_per_sec": None,
            "tflops_per_sec": None,
            "mfu": None,
            "numerics": dict(numerics) if numerics else None,
            "memory": dict(memory) if memory else None,
            "process_index": ident.process_index,
            "process_count": ident.process_count,
        }
        if ident.run_id:
            fields["run_id"] = ident.run_id
        if scaler_state is not None:
            fields["loss_scale"] = _host_float(
                getattr(scaler_state, "loss_scale", None))
            ovf = _host_float(getattr(scaler_state, "overflows", None))
            fields["overflow_count"] = None if ovf is None else int(ovf)
        if self.tokens_per_step:
            fields["tokens_per_sec"] = round(
                self.tokens_per_step / step_time_s, 1)
        if self.flops_per_step:
            achieved = self.flops_per_step / step_time_s
            fields["tflops_per_sec"] = round(achieved / 1e12, 2)
            if self.peak:
                mfu = achieved / self.peak
                fields["mfu"] = round(mfu, 4)
                if mfu > 1.0:
                    fields["mfu_suspect"] = (
                        "MFU>1 is impossible: timing failed to sync the "
                        "device")
        if self.device_kind:
            fields["device_kind"] = self.device_kind
        fields.update(extra)

        reg = self.registry
        reg.histogram(f"{self.name}/step_time_ms").observe(
            fields["step_time_ms"])
        reg.counter(f"{self.name}/steps").inc()
        if fields["loss"] is not None:
            reg.gauge(f"{self.name}/loss").set(fields["loss"])
        if fields["loss_scale"] is not None:
            reg.gauge(f"{self.name}/loss_scale").set(fields["loss_scale"])
        if fields["overflow_count"] is not None:
            reg.gauge(f"{self.name}/overflow_count").set(
                fields["overflow_count"])
        reg.event("step", **fields)

        self.records.append(fields)
        return fields

    def summary(self) -> dict:
        """Mean/min step time + last throughput fields over recorded
        steps."""
        if not self.records:
            return {}
        times = [r["step_time_ms"] for r in self.records]
        out = {"steps": len(self.records),
               "step_time_ms_mean": round(sum(times) / len(times), 3),
               "step_time_ms_min": round(min(times), 3)}
        last = self.records[-1]
        for f in ("tokens_per_sec", "tflops_per_sec", "mfu",
                  "device_kind"):
            if last.get(f) is not None:
                out[f] = last[f]
        return out
