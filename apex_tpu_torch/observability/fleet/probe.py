"""Per-step barrier-wait probe around the grad-sync call sites (port of
``apex_tpu/observability/fleet/probe.py``).

A straggling rank is invisible from inside its own process: every rank
just sees "the all-reduce got slow". What *is* measurable per rank is
the pre-collective wait: the gap between this rank's gradients being
ready (it reaches the collective) and the collective completing (every
rank arrived). Fast ranks wait long; the straggler barely waits at all.
Comparing those waits across ranks names the slow rank
(:mod:`~apex_tpu_torch.observability.fleet.straggler`).

The grad-sync call sites (``parallel/distributed.py``'s per-leaf and
flat syncs, ``parallel/overlap.py``'s bucketed sync, ``parallel/zero.py``'s
ZeRO-1 step) wrap their collectives::

    flat = probe.collective_enter(flat, "ddp/overlap/bucket0/bfloat16",
                                  axis_name)
    work = torch.distributed.all_reduce(flat, group=g, async_op=True)
    work.wait()
    flat = probe.collective_exit(flat, "ddp/overlap/bucket0/bfloat16",
                                 axis_name)

Disabled (the default) both return their argument and do nothing else:
no synchronisation, no event, no launch. Enabled (:func:`enable` /
``APEX_TPU_FLEET_PROBE=1``), each marks its moment on the host clock
once the tensor is ready on the card: ``collective_enter`` synchronises
the tensor's current stream before it reads the clock (the kernels that
made the operand are asynchronous, so the moment the host reaches the
call is not the moment the operand is ready), and ``collective_exit``
does the same after the caller waited on the collective (an async
``work`` exits at its ``wait()``, not at its issue). The probe thereby
serialises the host with the card at every probed collective: a cost
paid only while it is on.

Per (site, rank) the host records ``wait = t_exit - t_enter`` into the
``fleet/grad_sync_wait_s{site=,rank=}`` timer, remembers the last
collective each rank entered (the flight recorder dumps it so the fleet
collector can say where a stuck rank is stuck), and feeds the wait into
a :class:`~apex_tpu_torch.observability.fleet.straggler.StragglerDetector`
(:func:`set_detector`). Each process records its own rank (its rank in
``axis_name``'s group); the cross-rank comparison is
:func:`~apex_tpu_torch.observability.fleet.merge.merge_fleet`'s, over the
ranks' dumps, as on the reference's real fleet.

The backward's bucket hooks (``overlapped_value_and_grad``) are not
probed, as the reference does not probe its ``custom_vjp`` backward.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

__all__ = [
    "enable", "disable", "enabled", "collective_enter",
    "collective_exit", "last_collective", "last_collectives",
    "wait_times", "reset", "set_detector",
]

_LOCK = threading.Lock()
_ENABLED: Optional[bool] = None      # None = consult the env once
_ENTERS: dict = {}                   # (site, rank) -> perf_counter at enter
_LAST: dict = {}                     # rank -> site of last collective entered
_WAITS: dict = {}                    # (site, rank) -> last wait seconds
_DETECTOR = None                     # optional straggler.StragglerDetector
_STEPS: dict = {}                    # site -> completed detector rounds
_FRESH: dict = {}                    # site -> ranks with a wait since the
#                                      last detector round fed


def enabled() -> bool:
    """Is the probe armed? Explicit :func:`enable`/:func:`disable` wins;
    otherwise ``APEX_TPU_FLEET_PROBE=1`` arms it."""
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get("APEX_TPU_FLEET_PROBE", "") == "1"


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop recorded waits/markers and return to env-driven arming
    (tests; a long-lived process between runs)."""
    global _ENABLED, _DETECTOR
    with _LOCK:
        _ENABLED = None
        _DETECTOR = None
        _ENTERS.clear()
        _LAST.clear()
        _WAITS.clear()
        _STEPS.clear()
        _FRESH.clear()


def set_detector(detector) -> None:
    """Feed every completed (site, per-rank wait) round into a
    :class:`~apex_tpu_torch.observability.fleet.straggler.StragglerDetector`
    (mode ``"wait"``)."""
    global _DETECTOR
    _DETECTOR = detector


def last_collective(rank: Optional[int] = None) -> Optional[str]:
    """Site of the last collective this process's rank(s) entered.
    Without ``rank``: the most recent across the local ranks."""
    with _LOCK:
        if rank is not None:
            return _LAST.get(int(rank))
        # _LAST is insertion-ordered; the most recent write is last
        return next(reversed(_LAST.values()), None) if _LAST else None


def last_collectives() -> dict:
    """{rank: site} of each local rank's last entered collective."""
    with _LOCK:
        return dict(_LAST)


def wait_times() -> dict:
    """{(site, rank): last wait seconds} — test/inspection hook."""
    with _LOCK:
        return dict(_WAITS)


def _reg():
    from apex_tpu_torch.observability import get_registry
    return get_registry()


def _on_enter(site: str, rank) -> None:
    rank = int(rank)
    with _LOCK:
        _ENTERS[(site, rank)] = time.perf_counter()
        # pop first so insertion order tracks recency
        _LAST.pop(rank, None)
        _LAST[rank] = site


def _on_exit(site: str, rank) -> None:
    rank = int(rank)
    now = time.perf_counter()
    detector_round = None
    with _LOCK:
        start = _ENTERS.pop((site, rank), None)
        if start is None:
            return  # exit without enter: the probe was armed mid-call
        wait = now - start
        _WAITS[(site, rank)] = wait
        if _DETECTOR is not None:
            # a "round" completes when every rank seen so far for this
            # site has a FRESH wait since the last round
            fresh = _FRESH.setdefault(site, set())
            fresh.add(rank)
            ranks = {r for s, r in _WAITS if s == site}
            if fresh >= ranks:
                step = _STEPS.get(site, 0)
                _STEPS[site] = step + 1
                # a {rank: wait} mapping, NOT a positional list: the
                # locally-hosted ranks need not be 0..n-1
                detector_round = (step, {
                    r: _WAITS[(site, r)] for r in sorted(ranks)})
                fresh.clear()
    reg = _reg()
    reg.timer("fleet/grad_sync_wait_s", site=site,
              rank=str(rank)).observe(wait)
    if detector_round is not None:
        step, waits = detector_round
        _DETECTOR.observe(step, waits, site=site)


def _ready(x) -> None:
    """Wait until ``x`` is ready on its card (its current stream's work
    done); nothing for a CPU tensor."""
    import torch

    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def _rank(axis_name) -> int:
    from apex_tpu_torch.distributed import backend

    return backend.get_rank(axis_name)


def collective_enter(x, site: str, axis_name):
    """Mark "this rank's operand is ready, entering ``site``" and return
    ``x``. Identity when the probe is off."""
    if not enabled():
        return x
    _ready(x)
    _on_enter(site, _rank(axis_name))
    return x


def collective_exit(x, site: str, axis_name):
    """Mark "``site`` completed on this rank" once ``x`` (the reduced
    result, after the caller's ``wait()``) is ready; returns ``x``.
    Identity when the probe is off."""
    if not enabled():
        return x
    _ready(x)
    _on_exit(site, _rank(axis_name))
    return x
