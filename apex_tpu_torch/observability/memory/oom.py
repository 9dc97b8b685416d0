"""OOM forensics (port of ``apex_tpu/observability/memory/oom.py``).

An OOM kills a run with nothing but an exception string. This module
turns that string into a structured post-mortem:

- :func:`is_oom_error` - classify an exception as resource exhaustion:
  ``torch.OutOfMemoryError``, or any error whose text carries one of
  the reference's markers (CUDA's "out of memory" among them);
- :func:`parse_resource_exhausted` - pull the numbers out of the
  message. The reference parses XLA's RESOURCE_EXHAUSTED text; the port
  parses PyTorch's ("Tried to allocate 81.00 GiB. GPU 0 has a total
  capacity of 79.19 GiB of which 78.54 GiB is free. ...", and the older
  "(GPU 0; 79.35 GiB total capacity; ...; 1.23 GiB free; ...)") into
  the same keys - requested bytes, capacity as ``limit_bytes``, free
  bytes - and still reads the reference's own formats (the chaos
  ``oom`` fault raises one). A message shape the parser has never seen
  degrades to ``matched=False``, never a raise;
- :func:`dump_memrec` - write the ``memrec_*.json`` artifact: the
  parse, the active :class:`~.hbm.MemoryMonitor`'s watermark + last
  snapshot, a fresh live-tensor snapshot, every thread's stack (the
  flight recorder's shared ingredient) and the trailing registry
  events. Rank + pid + serial in the filename keep concurrent dumps
  collision-free, exactly like ``flightrec_*``. Its ``compiled`` section
  is None: the port has no per-executable memory capture yet
  (``memory/compiled.py``, ROADMAP.md Queue 1 item 7), as the reference
  writes it when none is installed;
- :func:`oom_forensics` - the one-call entry point
  :class:`~apex_tpu_torch.resilience.ResilientTrainLoop` runs when a step
  dies OOM-shaped: dump + return the compact verdict (requested bytes,
  capacity, largest live buffer, watermark) that rides every
  ``rollback`` event and ``TrainAborted.report["memory"]``.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import time
from typing import Optional

__all__ = [
    "OOM_MARKERS", "is_oom_error", "parse_resource_exhausted",
    "dump_memrec", "oom_forensics",
]

#: substrings that mark an exception as resource exhaustion (matched
#: against repr(); the reference's markers, CUDA's "out of memory" among
#: them).
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "Ran out of memory", "OOM")

# "... allocate 1073741824 bytes" (BFC / host allocators)
_ALLOC_BYTES_RE = re.compile(
    r"allocat(?:e|ing)\s+([\d,]+)\s*bytes", re.IGNORECASE)
# "Attempting to allocate 1.17G" / "Used 19.46G of 15.48G hbm"
_SIZE = r"([\d.]+)\s*([KMGTP]i?)?B?"
_ALLOC_SIZE_RE = re.compile(
    r"(?:attempting to allocate|trying to allocate)\s+" + _SIZE,
    re.IGNORECASE)
_USED_OF_RE = re.compile(
    r"Used\s+" + _SIZE + r"\s+of\s+" + _SIZE, re.IGNORECASE)
_FREE_RE = re.compile(r"([\d.]+)\s*([KMGTP]i?)?B?\s+free",
                      re.IGNORECASE)
# the reference's compiler usage table: "    program          18.93G"
_BREAKDOWN_RE = re.compile(
    r"^\s{2,}(reserved|program|arguments|global|scoped|HLO temp|"
    r"stack)\s+" + _SIZE + r"\s*(?:\(|$)", re.MULTILINE)
# "  1. Size: 2.50G" entries under "Largest program allocations"
_LARGEST_RE = re.compile(r"^\s*\d+\.\s+Size:\s+" + _SIZE,
                         re.MULTILINE)
_OPERATOR_RE = re.compile(r'Operator:\s*op_name="([^"]*)"')
# PyTorch's CUDA allocator: "Tried to allocate 81.00 GiB. GPU 0 has a
# total capacity of 79.19 GiB of which 78.54 GiB is free." (sizes from
# its format_size: bytes, KiB, MiB, GiB)
_PT_SIZE = r"([\d.]+)\s*(?:([KMGTP]i?)B\b|bytes)"
_PT_ALLOC_RE = re.compile(r"Tried to allocate\s+" + _PT_SIZE, re.IGNORECASE)
_PT_CAPACITY_RE = re.compile(r"total capacity of\s+" + _PT_SIZE,
                             re.IGNORECASE)
_PT_CAPACITY_OLD_RE = re.compile(_PT_SIZE + r"\s+total capacity",
                                 re.IGNORECASE)
_PT_FREE_RE = re.compile(_PT_SIZE + r"\s+(?:is\s+)?free", re.IGNORECASE)

_SUFFIX = {None: 1, "": 1,
           "K": 1 << 10, "Ki": 1 << 10, "M": 1 << 20, "Mi": 1 << 20,
           "G": 1 << 30, "Gi": 1 << 30, "T": 1 << 40, "Ti": 1 << 40,
           "P": 1 << 50, "Pi": 1 << 50}

# process-wide memrec serial (same collision contract as flightrec_*)
_DUMP_SEQ = itertools.count()


def _to_bytes(num: str, suffix: Optional[str]) -> Optional[int]:
    try:
        return int(float(num.replace(",", ""))
                   * _SUFFIX.get(suffix or "", 1))
    except (TypeError, ValueError):
        return None


def is_oom_error(exc) -> bool:
    """True when ``exc`` (an exception or message string) is resource
    exhaustion - ``torch.OutOfMemoryError``, or a message with one of
    :data:`OOM_MARKERS` (a ``RuntimeError`` carrying CUDA's "out of
    memory"). A cheaper rung (smaller batch, rollback) may dodge it;
    anything else must fail fast."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = exc if isinstance(exc, str) else repr(exc)
    return any(marker in text for marker in OOM_MARKERS)


def _first_size(patterns, text) -> Optional[int]:
    for pattern in patterns:
        m = pattern.search(text)
        if m:
            return _to_bytes(m.group(1), m.group(2))
    return None


def parse_resource_exhausted(text: str) -> dict:
    """Best-effort structured parse of an out-of-memory message
    (PyTorch's CUDA allocator's or the reference's RESOURCE_EXHAUSTED).

    Returns ``{matched, requested_bytes, limit_bytes, free_bytes,
    breakdown, largest_allocations}`` — unknown fields None/empty, and
    ``matched`` False when no byte figure parsed at all (the caller
    still gets the raw message elsewhere)."""
    text = text or ""
    requested = _first_size((_PT_ALLOC_RE,), text)
    limit = _first_size((_PT_CAPACITY_RE, _PT_CAPACITY_OLD_RE), text)
    free = _first_size((_PT_FREE_RE,), text)
    m = None if requested is not None else _ALLOC_BYTES_RE.search(text)
    if m:
        requested = _to_bytes(m.group(1), None)
    if requested is None:
        m = _ALLOC_SIZE_RE.search(text)
        if m:
            requested = _to_bytes(m.group(1), m.group(2))
    m = _USED_OF_RE.search(text)
    if m:
        if requested is None:
            requested = _to_bytes(m.group(1), m.group(2))
        if limit is None:
            limit = _to_bytes(m.group(3), m.group(4))
    if free is None:
        m = _FREE_RE.search(text)
        if m:
            free = _to_bytes(m.group(1), m.group(2))

    breakdown = {}
    for m in _BREAKDOWN_RE.finditer(text):
        nbytes = _to_bytes(m.group(2), m.group(3))
        if nbytes is not None:
            breakdown[m.group(1)] = nbytes

    # each size entry's Operator line is searched only in ITS span
    # (up to the next numbered entry): an entry without one (padding /
    # unknown allocations) must not shift every later attribution
    largest = []
    size_matches = list(_LARGEST_RE.finditer(text))
    for i, m in enumerate(size_matches):
        nbytes = _to_bytes(m.group(1), m.group(2))
        if nbytes is None:
            continue
        entry = {"nbytes": nbytes}
        span_end = (size_matches[i + 1].start()
                    if i + 1 < len(size_matches) else len(text))
        op = _OPERATOR_RE.search(text, m.end(), span_end)
        if op:
            entry["op_name"] = op.group(1)
        largest.append(entry)

    return {
        "matched": requested is not None or bool(breakdown)
        or bool(largest),
        "requested_bytes": requested,
        "limit_bytes": limit,
        "free_bytes": free,
        "breakdown": breakdown,
        "largest_allocations": largest,
    }


def _default_dir() -> str:
    # the flight recorder owns the artifact-directory policy — a memrec
    # must land next to the flightrec so one story tells both dumps
    from apex_tpu_torch.observability.profiling import flight_recorder
    return flight_recorder._default_dir()


def dump_memrec(error=None, *, monitor=None, registry=None,
                directory: Optional[str] = None,
                step: Optional[int] = None, kind: str = "oom",
                max_events: int = 100) -> Optional[str]:
    """Write the ``memrec_*.json`` OOM post-mortem; returns its path
    (None when even the write failed — forensics must never take down
    the run). ``monitor`` defaults to the active
    :class:`~.hbm.MemoryMonitor`."""
    from apex_tpu_torch.observability.fleet.identity import (
        FleetIdentity,
        identity_fields,
        process_identity,
    )
    from apex_tpu_torch.observability.memory import hbm
    from apex_tpu_torch.observability.profiling.flight_recorder import (
        thread_stacks,
    )

    reg = registry
    if reg is None:
        from apex_tpu_torch.observability.registry import get_registry
        reg = get_registry()
    if monitor is None:
        monitor = hbm.active_monitor()
    try:
        ident = process_identity()
    except ValueError:
        ident = FleetIdentity(0, 1, None)
    error_text = None if error is None else (
        error if isinstance(error, str) else repr(error))
    device = _device_of(monitor)
    try:
        snapshot = None if device is None else hbm.memory_snapshot(
            top_k=monitor.top_k if monitor is not None else 5,
            device=device)
    except Exception as e:  # noqa: BLE001 — the device may be the
        # thing that just died; the parse + watermark still dump
        snapshot = {"error": repr(e)[:200]}
    payload = {
        "kind": "apex_tpu.memory_record",
        "schema_version": hbm.MEMORY_SCHEMA_VERSION,
        **identity_fields(ident),
        "trigger": kind,
        "pid": os.getpid(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "step": step,
        "error": None if error_text is None else error_text[:4000],
        "oom": None if error_text is None
        else parse_resource_exhausted(error_text),
        "monitor": monitor.summary() if monitor is not None else None,
        "snapshot": snapshot,
        "compiled": None,  # no per-executable capture (docstring)
        "thread_stacks": thread_stacks(),
        "events": (reg.events()[-max_events:] if max_events > 0
                   else []),
    }
    fname = (f"memrec_{time.strftime('%Y%m%d-%H%M%S')}_"
             f"r{ident.process_index}_{os.getpid()}_"
             f"{next(_DUMP_SEQ)}_{kind}.json")
    path = os.path.join(directory or _default_dir(), fname)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=repr)
    except OSError as e:
        reg.counter("memory/memrec_dump_failures").inc()
        reg.event("memrec_dump_failed", error=repr(e)[:200])
        return None
    reg.counter("memory/memrec_dumps").inc()
    reg.event("memory_record", path=path, trigger=kind, step=step)
    return path


def _device_of(monitor):
    """The device a post-mortem reads: the monitor's, else the current
    card once CUDA is up, else None (nothing to read: absence)."""
    from apex_tpu_torch.observability.memory import hbm

    if monitor is not None:
        return monitor.device
    return hbm._section_device()


def oom_forensics(error, *, monitor=None, registry=None,
                  directory: Optional[str] = None,
                  step: Optional[int] = None) -> dict:
    """The one-call OOM post-mortem the resilience loop runs: dump a
    memrec artifact and return the compact verdict dict
    (``requested_bytes``, ``largest_buffer``, ``live_bytes``,
    ``watermark_bytes``, ``memrec`` path, the truncated error). Never
    raises — any failure degrades to fields of the verdict."""
    from apex_tpu_torch.observability.memory import hbm

    if monitor is None:
        monitor = hbm.active_monitor()
    error_text = error if isinstance(error, str) else repr(error)
    parsed = parse_resource_exhausted(error_text)
    verdict = {
        "requested_bytes": parsed.get("requested_bytes"),
        "limit_bytes": parsed.get("limit_bytes"),
        "largest_buffer": None,
        "live_bytes": None,
        "watermark_bytes": (monitor.summary()["watermark_bytes"]
                            if monitor is not None else None),
        "error": error_text[:500],
        "memrec": None,
    }
    device = _device_of(monitor)
    try:
        if device is None:
            raise RuntimeError("no device memory to read")
        snap = hbm.memory_snapshot(top_k=1, device=device)
        verdict["live_bytes"] = snap["live_bytes"]
        if snap["top"]:
            verdict["largest_buffer"] = snap["top"][0]
    except Exception:  # noqa: BLE001 — the device may be down; the
        # monitor's last snapshot is the fallback attribution
        if monitor is not None and monitor.last:
            verdict["live_bytes"] = monitor.last.get("live_bytes")
            top = monitor.last.get("top") or []
            verdict["largest_buffer"] = top[0] if top else None
    try:
        verdict["memrec"] = dump_memrec(
            error, monitor=monitor, registry=registry,
            directory=directory, step=step)
    except Exception:  # noqa: BLE001 — verdict without artifact is
        # still a verdict
        verdict["memrec"] = None
    return verdict
