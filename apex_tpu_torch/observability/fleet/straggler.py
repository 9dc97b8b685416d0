"""Trailing-median cross-rank skew detector → ``fleet/straggler`` (port
of ``apex_tpu/observability/fleet/straggler.py``).

One detector, two orientations of the same verdict:

- ``mode="wait"`` (the live grad-sync probe feed): each observation is
  the per-rank **pre-collective wait**. The straggler is the rank with
  the *smallest* trailing-median wait while the rest of the fleet
  waits long — everyone queues at the collective until the slow rank
  arrives, so the slow rank itself is the one that never waits.
- ``mode="step_time"`` (the merge-time feed over per-rank step-time
  shards): each observation is the per-rank **step duration**; the
  straggler is simply the rank with the *largest* trailing median.

Detection is trailing-median based so one noisy step never fires: per
rank a bounded deque of the last ``history`` observations; once every
rank has ``min_history`` samples, the fleet median (median of per-rank
medians) anchors the skew test. A rank is a straggler when the skew —
``spread / fleet_median`` with spread = |outlier median − fleet
median| — exceeds ``threshold``. Verdicts are edge-triggered per rank
(an event on the transition into straggling, a counter bump per
detection, re-armed when the rank recovers), emitted as
``fleet/straggler`` events naming the slow rank plus the
``fleet/stragglers{rank=}`` counter family.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

__all__ = ["StragglerDetector", "DEFAULT_SKEW_THRESHOLDS"]

# Relative-skew trigger per mode. Wait skew is bounded by 1.0 (a wait
# cannot go below zero, so the outlier can sit at most one full fleet
# median below it) — 0.5 means "the straggler waits less than half of
# what the fleet does". Step-time skew is unbounded above; 1.0 means
# "one rank's steps take twice the fleet median".
DEFAULT_SKEW_THRESHOLDS = {"wait": 0.5, "step_time": 1.0}

_MODES = ("wait", "step_time")


class StragglerDetector:
    """Feed per-rank series, get ``fleet/straggler`` verdicts.

    Parameters
    ----------
    mode: ``"wait"`` (straggler = min wait) or ``"step_time"``
        (straggler = max duration).
    threshold: relative skew (spread over fleet median) that fires.
    min_history / history: samples per rank to arm / window size.
    registry: metric sink (default: the process registry).
    """

    def __init__(self, mode: str = "wait",
                 threshold: Optional[float] = None,
                 min_history: int = 5, history: int = 64,
                 registry=None):
        if mode not in _MODES:
            raise ValueError(f"unknown straggler mode {mode!r}; "
                             f"valid: {list(_MODES)}")
        if threshold is None:
            threshold = DEFAULT_SKEW_THRESHOLDS[mode]
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.mode = mode
        self.threshold = float(threshold)
        self.min_history = int(min_history)
        self.history = int(history)
        self._series: dict = {}   # rank -> deque of observations
        self._flagged: dict = {}  # rank -> True while straggling
        self._registry = registry
        self.verdicts: list = []  # every verdict dict emitted

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability import get_registry
        return get_registry()

    # ---------------------------------------------------------- feed

    def observe(self, step: int, per_rank,
                site: str = "step") -> Optional[dict]:
        """Record one round of per-rank observations — either a
        ``{rank: value}`` mapping (the probe's form: the locally
        hosted ranks need not be ``0..n-1``) or a sequence indexed by
        rank. Returns the verdict dict when a NEW straggler was named
        this round, else None."""
        items = (per_rank.items() if isinstance(per_rank, dict)
                 else enumerate(per_rank))
        for rank, value in items:
            self._series.setdefault(
                int(rank),
                collections.deque(maxlen=self.history)).append(
                float(value))
        return self._detect(step, site)

    def medians(self) -> dict:
        """{rank: trailing median} over the armed ranks."""
        return {rank: statistics.median(series)
                for rank, series in sorted(self._series.items())
                if len(series) >= self.min_history}

    # --------------------------------------------------------- verdict

    def _detect(self, step: int, site: str) -> Optional[dict]:
        meds = self.medians()
        if len(meds) < 2 or len(meds) < len(self._series):
            return None  # not every rank armed yet
        fleet_median = statistics.median(meds.values())
        pick = min if self.mode == "wait" else max
        rank = pick(meds, key=lambda r: meds[r])
        spread = abs(meds[rank] - fleet_median)
        skew = spread / max(fleet_median, 1e-12)
        reg = self._reg()
        reg.gauge("fleet/skew", site=site).set(round(skew, 4))
        if skew <= self.threshold:
            # recovery re-arms the edge trigger for every rank
            self._flagged.clear()
            return None
        reg.counter("fleet/stragglers", rank=str(rank)).inc()
        verdict = {
            "step": int(step), "rank": int(rank), "site": site,
            "mode": self.mode, "skew": round(skew, 4),
            "rank_median_s": meds[rank], "fleet_median_s": fleet_median,
            "rank_medians": {str(r): round(m, 6)
                             for r, m in meds.items()},
        }
        newly = not self._flagged.get(rank)
        self._flagged = {rank: True}
        if newly:
            reg.event("fleet/straggler", **verdict)
            self.verdicts.append(verdict)
            return verdict
        return None
