"""Training-health detectors (port of
``apex_tpu/observability/numerics/health.py``, copied: pure Python over
host floats): grad-norm spikes, loss plateaus/spikes, scaler overflow
streaks.

A numerics incident rarely starts at the NaN - it starts steps earlier
as a grad-norm spike or an overflow streak the scaler keeps eating.
:class:`HealthMonitor` watches the host-side per-step signals every
example already has in hand (loss, grad norm, the scaler's ``report()``
dict) and emits the ``numerics/*`` counter/gauge family plus structured
events the moment a trajectory turns pathological - BEFORE the
resilience ladder has to roll anything back.

All detectors are trailing-median based (robust to the occasional
outlier step) and fire as edge triggers: one event when a condition is
entered, not one per step it persists.
"""

from __future__ import annotations

import collections
import math
import statistics
from typing import Optional

__all__ = ["HealthMonitor"]


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


class HealthMonitor:
    """Feed one ``observe(step, ...)`` per training step; returns the
    list of detector events fired this step (also appended to the
    registry's event stream).

    Detectors:

    - **grad-norm spike** — ``grad_norm`` above ``grad_spike_factor``
      x the trailing-window median (counter
      ``numerics/grad_norm_spikes``, event ``numerics_grad_spike``;
      the ``numerics/grad_norm`` histogram records every finite
      value);
    - **loss spike** — same rule on ``loss``
      (``numerics/loss_spikes`` / ``numerics_loss_spike``);
    - **loss plateau** — the last ``plateau_window`` losses span less
      than ``plateau_rtol`` x their median magnitude
      (``numerics/loss_plateaus`` / ``numerics_loss_plateau``; off by
      default — short smoke runs plateau legitimately);
    - **non-finite signal** — a NaN/Inf loss or grad norm flips the
      ``numerics/finite{source=<name>:<signal>}`` gauge to 0 and counts
      ``numerics/nonfinite_signals``;
    - **overflow streak** — the scaler's ``skip_streak`` (consecutive
      overflow-skipped steps) at or past
      ``overflow_streak_threshold`` fires
      ``numerics/overflow_streaks`` / ``numerics_overflow_streak``;
      ``last_overflow_step`` and the streak ride along as gauges.
    """

    def __init__(self, name: str = "train", registry=None,
                 window: int = 32, min_samples: int = 5,
                 grad_spike_factor: float = 10.0,
                 loss_spike_factor: float = 10.0,
                 plateau_window: int = 0,
                 plateau_rtol: float = 1e-4,
                 overflow_streak_threshold: int = 3):
        self.name = name
        self._registry = registry
        self.window = max(int(window), 2)
        self.min_samples = max(int(min_samples), 2)
        self.grad_spike_factor = float(grad_spike_factor)
        self.loss_spike_factor = float(loss_spike_factor)
        self.plateau_window = int(plateau_window)
        self.plateau_rtol = float(plateau_rtol)
        self.overflow_streak_threshold = int(overflow_streak_threshold)
        self._grads = collections.deque(maxlen=self.window)
        self._losses = collections.deque(maxlen=self.window)
        self._in_plateau = False
        self._streak_fired = False

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability.registry import get_registry
        return get_registry()

    # ---- detectors ---------------------------------------------------

    def _spike(self, history, value: float, factor: float):
        """(median, spiked?) vs the trailing history (value not yet
        appended)."""
        if len(history) < self.min_samples:
            return None, False
        med = statistics.median(history)
        return med, med > 0 and value > factor * med

    def _check_signal(self, reg, events, step, signal: str, raw,
                      history, factor: float, counter: str,
                      event_name: str):
        if raw is None:
            return None
        value = _finite(raw)
        reg.gauge("numerics/finite",
                  source=f"{self.name}:{signal}").set(
            1.0 if value is not None else 0.0)
        if value is None:
            reg.counter("numerics/nonfinite_signals",
                        source=self.name, signal=signal).inc()
            events.append({"event": "numerics_nonfinite",
                           "signal": signal, "step": step})
            return None
        med, spiked = self._spike(history, value, factor)
        if spiked:
            reg.counter(counter, source=self.name).inc()
            events.append({"event": event_name, "step": step,
                           "value": value, "median": med,
                           "factor": factor})
        history.append(value)
        return value

    def observe(self, step: int, loss=None, grad_norm=None,
                scaler_report: Optional[dict] = None) -> list:
        """Record one step's signals; returns the detector events
        fired (each also lands as a registry event)."""
        reg = self._reg()
        events: list = []

        g = self._check_signal(
            reg, events, step, "grad_norm", grad_norm, self._grads,
            self.grad_spike_factor, "numerics/grad_norm_spikes",
            "numerics_grad_spike")
        if g is not None:
            reg.histogram("numerics/grad_norm",
                          source=self.name).observe(g)

        loss_f = self._check_signal(
            reg, events, step, "loss", loss, self._losses,
            self.loss_spike_factor, "numerics/loss_spikes",
            "numerics_loss_spike")
        if loss_f is not None and self.plateau_window > 1 and \
                len(self._losses) >= self.plateau_window:
            recent = list(self._losses)[-self.plateau_window:]
            span = max(recent) - min(recent)
            scale = max(abs(statistics.median(recent)), 1e-12)
            if span <= self.plateau_rtol * scale:
                if not self._in_plateau:
                    self._in_plateau = True
                    reg.counter("numerics/loss_plateaus",
                                source=self.name).inc()
                    events.append({"event": "numerics_loss_plateau",
                                   "step": step, "span": span,
                                   "window": self.plateau_window})
            else:
                self._in_plateau = False

        if scaler_report:
            streak = int(scaler_report.get("skip_streak", 0) or 0)
            last_ovf = scaler_report.get("last_overflow_step")
            reg.gauge("numerics/overflow_streak",
                      source=self.name).set(streak)
            if last_ovf is not None:
                reg.gauge("numerics/last_overflow_step",
                          source=self.name).set(int(last_ovf))
            if streak >= self.overflow_streak_threshold:
                if not self._streak_fired:
                    self._streak_fired = True
                    reg.counter("numerics/overflow_streaks",
                                source=self.name).inc()
                    events.append({
                        "event": "numerics_overflow_streak",
                        "step": step, "streak": streak,
                        "last_overflow_step": last_ovf,
                        "loss_scale": scaler_report.get("loss_scale"),
                    })
            else:
                self._streak_fired = False

        for ev in events:
            reg.event(ev["event"], source=self.name,
                      **{k: v for k, v in ev.items() if k != "event"})
        return events
