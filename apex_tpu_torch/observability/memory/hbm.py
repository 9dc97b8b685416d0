"""Live device-memory telemetry (port of
``apex_tpu/observability/memory/hbm.py``).

:class:`MemoryMonitor` is the live side of the memory tier:

- **decimated live-bytes snapshots** - one walk over the live tensors
  plus the CUDA caching allocator's own counters. The reference walks
  ``jax.live_arrays()``; PyTorch has no such list, so
  :func:`live_buffer_records` walks the objects the ``gc`` module
  tracks, keeps the ``torch.Tensor`` objects on the device, and counts
  each storage once (by ``untyped_storage().data_ptr()``): a view and
  its base are one buffer. Tensors held only by C++ (autograd's saved
  tensors, the allocator's cache) are not Python objects and are not in
  the walk; the allocator's ``bytes_in_use`` counts them. The walk runs
  only every ``every`` steps - off-cadence steps cost nothing;
- **watermark** - the process's ``torch.cuda.max_memory_allocated`` on
  the card (the CUDA allocator's peak since the last reset), the largest
  live total any snapshot saw on the CPU;
- **top-k largest buffers** - shape/dtype/bytes of the tensors that
  dominate the live set, the first thing an OOM post-mortem needs;
- the ``memory/*`` gauge family + ``memory_snapshot`` events in the
  registry, and :meth:`MemoryMonitor.dump` - an identity-stamped,
  ``rank_path``-suffixed JSON artifact.

Entry points that read the device (``MemoryMonitor()``,
:func:`device_memory_stats`, :func:`memory_snapshot`) run on the card
unless given ``device="cpu"``, and raise without one. On the CPU the
allocator reports nothing: ``device_memory_stats`` is ``{}``, absence,
never invented zeros, as the reference's CPU backend gives.

:func:`device_memory_stats` fills the reference's field names from
``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``:

=====================  ==========================================
``bytes_in_use``       ``allocated_bytes.all.current``
``peak_bytes_in_use``  ``allocated_bytes.all.peak``
``bytes_limit``        total of ``mem_get_info``
``bytes_reserved``     ``reserved_bytes.all.current``
=====================  ==========================================

``bytes_reserved`` is the name XLA's GPU allocator reports the same
quantity under; the reference's ``largest_alloc_size`` has no PyTorch
counterpart and is absent.
"""

from __future__ import annotations

import gc
import json
from typing import Optional

__all__ = [
    "MEMORY_SCHEMA_VERSION", "MEMORY_STATS_FIELDS", "live_buffer_records",
    "device_live_bytes", "device_memory_stats", "memory_snapshot",
    "MemoryMonitor", "active_monitor", "set_active_monitor",
    "flight_section",
]

MEMORY_SCHEMA_VERSION = 1

#: the allocator fields a snapshot carries (see the module docstring for
#: where each comes from)
MEMORY_STATS_FIELDS = ("bytes_in_use", "peak_bytes_in_use",
                       "bytes_limit", "bytes_reserved")


def _resolve(device):
    from apex_tpu_torch import _device

    return _device.resolve(device)


def _on(tensor_device, device) -> bool:
    if tensor_device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    return (tensor_device.index or 0) == (device.index or 0)


def live_buffer_records(top_k: Optional[int] = None, device=None) -> list:
    """One record per live storage on ``device`` (the card unless the
    CPU is asked for), largest first: ``{shape, dtype, nbytes, devices,
    per_device}``, the reference's keys. ``nbytes`` is the storage's
    physical size; ``shape`` and ``dtype`` are those of the first tensor
    the walk met on it. ``top_k`` truncates after sorting. Host-only: no
    device sync, no launch."""
    import torch

    device = _resolve(device)
    seen = {}
    skipped = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which
        # some module-level proxies answer with a deprecation warning
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if not _on(obj.device, device) or obj.is_meta:
                continue
            storage = obj.untyped_storage()
            ptr = storage.data_ptr()
            nbytes = int(storage.nbytes())
        except Exception:  # noqa: BLE001 - a tensor without a plain
            # storage (sparse, nested, freed under the walk) is counted
            # and skipped, never a raise
            skipped += 1
            continue
        if nbytes == 0 or ptr in seen:
            continue
        dev = str(obj.device)
        seen[ptr] = {"shape": [int(d) for d in obj.shape],
                     "dtype": str(obj.dtype).replace("torch.", ""),
                     "nbytes": nbytes, "devices": [dev],
                     "per_device": {dev: nbytes}}
    if skipped:
        from apex_tpu_torch.observability.registry import get_registry
        get_registry().counter("memory/buffers_skipped").inc(skipped)
    records = sorted(seen.values(),
                     key=lambda r: (-r["nbytes"], r["dtype"],
                                    tuple(r["shape"])))
    return records[:top_k] if top_k is not None else records


def device_live_bytes(records: Optional[list] = None, device=None) -> dict:
    """Per-device physical live bytes: ``{device_str: bytes}``. Pass
    the ``live_buffer_records()`` list already in hand to avoid a second
    walk."""
    if records is None:
        records = live_buffer_records(device=device)
    per_device: dict = {}
    for rec in records:
        for dev, nbytes in rec["per_device"].items():
            per_device[dev] = per_device.get(dev, 0) + nbytes
    return {d: int(b) for d, b in sorted(per_device.items())}


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's view of ``device`` (the card unless
    the CPU is asked for) under :data:`MEMORY_STATS_FIELDS`. ``{}`` on
    the CPU - absence, never fabricated zeros."""
    import torch

    device = _resolve(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    out = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
           "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
           "bytes_limit": total,
           "bytes_reserved": stats.get("reserved_bytes.all.current")}
    return {k: int(v) for k, v in out.items()
            if isinstance(v, (int, float))}


def memory_snapshot(top_k: int = 5, device=None) -> dict:
    """One full live-memory snapshot (the :class:`MemoryMonitor` unit
    of work): physical live-byte totals, per-device attribution, the
    top-k largest buffers, and the allocator stats where reported. ONE
    walk end to end."""
    device = _resolve(device)
    buffers = live_buffer_records(device=device)
    total = sum(r["nbytes"] for r in buffers)
    return {
        "live_bytes": int(total),
        "live_buffers": len(buffers),
        "per_device": device_live_bytes(buffers),
        "top": [{k: r[k] for k in ("shape", "dtype", "nbytes")}
                for r in buffers[:top_k]],
        "memory_stats": device_memory_stats(device) or None,
    }


def _watermark(device) -> Optional[int]:
    """The allocator's peak since its last reset on a card, else None."""
    import torch

    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class MemoryMonitor:
    """Decimated live-memory sampler: ``observe(step)`` takes a snapshot
    every ``every`` steps, tracks the watermark, and publishes the
    ``memory/*`` family; off-cadence steps cost nothing.

    Publishes per snapshot (all labeled ``source=<name>``):

    - gauges ``memory/live_bytes``, ``memory/live_buffers``,
      ``memory/watermark_bytes`` (+ ``memory/bytes_in_use`` /
      ``memory/peak_bytes_in_use`` / ``memory/bytes_limit`` /
      ``memory/bytes_reserved`` on a card);
    - timer ``memory/snapshot_pass`` - the walk's own cost;
    - counter ``memory/snapshots``; event ``memory_snapshot`` with the
      top-k buffers.

    ``last`` keeps the most recent summary - the ``memory`` block
    ``StepReporter.step(..., memory=monitor.last)`` attaches. The
    constructed monitor becomes the process's *active* monitor
    (:func:`active_monitor`), which is how flight-recorder and OOM dumps
    and the serving page budget find the watermark without a handle.
    ``device``: the card unless the CPU is asked for (raises without
    one).
    """

    def __init__(self, name: str = "memory", every: int = 16,
                 registry=None, top_k: int = 5, device=None):
        self.name = name
        self.every = max(int(every), 1)
        self.top_k = int(top_k)
        self.device = _resolve(device)
        self._registry = registry
        self.last: Optional[dict] = None
        self.watermark_bytes: int = 0
        self.watermark_step: Optional[int] = None
        self.snapshots: int = 0
        set_active_monitor(self)

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability.registry import get_registry
        return get_registry()

    def _raise_watermark(self, candidate: int, step) -> None:
        if candidate > self.watermark_bytes:
            self.watermark_bytes = int(candidate)
            self.watermark_step = None if step is None else int(step)

    def observe(self, step: int) -> Optional[dict]:
        """Take a snapshot when ``step`` is on cadence; returns the
        summary dict (also kept as ``last``), or None off-cadence."""
        if step % self.every:
            return None
        reg = self._reg()
        timer = reg.timer("memory/snapshot_pass", source=self.name)
        timer.start()
        try:
            snap = memory_snapshot(top_k=self.top_k, device=self.device)
        except BaseException:
            timer.cancel()
            raise
        elapsed = timer.stop()
        snap["step"] = int(step)
        snap["snapshot_ms"] = round(elapsed * 1e3, 3)
        peak = _watermark(self.device)
        self._raise_watermark(snap["live_bytes"] if peak is None else peak,
                              step)
        snap["watermark_bytes"] = self.watermark_bytes
        snap["watermark_step"] = self.watermark_step
        self.snapshots += 1
        reg.counter("memory/snapshots", source=self.name).inc()
        reg.gauge("memory/live_bytes", source=self.name).set(
            snap["live_bytes"])
        reg.gauge("memory/live_buffers", source=self.name).set(
            snap["live_buffers"])
        reg.gauge("memory/watermark_bytes", source=self.name).set(
            self.watermark_bytes)
        for key, value in (snap.get("memory_stats") or {}).items():
            reg.gauge(f"memory/{key}", source=self.name).set(value)
        reg.event("memory_snapshot", source=self.name, step=int(step),
                  live_bytes=snap["live_bytes"],
                  live_buffers=snap["live_buffers"],
                  watermark_bytes=self.watermark_bytes,
                  top=snap["top"])
        self.last = snap
        return snap

    def summary(self) -> dict:
        """The compact block flight-recorder / OOM dumps embed:
        watermark + the latest snapshot (None when no snapshot ran).
        On a card the watermark is read again here, so a post-mortem
        carries the allocator's peak up to the failure."""
        peak = _watermark(self.device)
        if peak is not None:
            self._raise_watermark(peak, self.watermark_step)
        return {
            "watermark_bytes": self.watermark_bytes,
            "watermark_step": self.watermark_step,
            "snapshots": self.snapshots,
            "last": self.last,
        }

    def dump(self, path: str) -> str:
        """Write the monitor's state (a fresh snapshot + watermark) as
        one identity-stamped JSON artifact at the ``rank_path``-suffixed
        variant of ``path``; returns the resolved path. ``compiled`` is
        the compiled-memory capture's per-graph table when one is
        installed, else None."""
        from apex_tpu_torch.observability.fleet.identity import (
            identity_fields,
            rank_path,
        )
        from apex_tpu_torch.observability.memory import compiled

        cap = compiled.current_capture()

        payload = {
            "kind": "apex_tpu.memory_record",
            "schema_version": MEMORY_SCHEMA_VERSION,
            **identity_fields(),
            **self.summary(),
            "snapshot": memory_snapshot(top_k=self.top_k,
                                        device=self.device),
            "compiled": cap.snapshot() if cap is not None else None,
        }
        resolved = rank_path(path)
        with open(resolved, "w") as f:
            json.dump(payload, f, indent=1, default=repr)
        self._reg().event("memory_dump", source=self.name,
                          path=resolved)
        return resolved


# ---------------------------------------------------- active monitor

_ACTIVE: "MemoryMonitor | None" = None


def active_monitor() -> "MemoryMonitor | None":
    """The most recently constructed :class:`MemoryMonitor` (None when
    no tier is running one) - the handle-free lookup the flight
    recorder, OOM forensics and the serving page budget use."""
    return _ACTIVE


def set_active_monitor(monitor: "MemoryMonitor | None"):
    """Swap the process's active monitor; returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, monitor
    return prev


def _section_device():
    """The device a post-mortem may read without bringing CUDA up: the
    active monitor's, else the current card once CUDA is initialised,
    else None."""
    import torch

    monitor = active_monitor()
    if monitor is not None:
        return monitor.device
    if torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def flight_section() -> "dict | None":
    """The ``memory`` block a flight-recorder / stall dump embeds:
    current live bytes + the active monitor's watermark and top
    buffers. Never raises and never initialises CUDA - returns None
    when no device is up or any read fails (a post-mortem must not take
    down the run it observes)."""
    try:
        device = _section_device()
        if device is None:
            return None
        monitor = active_monitor()
        section = {"live_bytes": None, "live_buffers": None,
                   "watermark_bytes": None, "top": None}
        snap = memory_snapshot(
            top_k=monitor.top_k if monitor is not None else 5,
            device=device)
        section["live_bytes"] = snap["live_bytes"]
        section["live_buffers"] = snap["live_buffers"]
        section["top"] = snap["top"]
        if snap.get("memory_stats"):
            section["memory_stats"] = snap["memory_stats"]
        if monitor is not None:
            summary = monitor.summary()
            section["watermark_bytes"] = summary["watermark_bytes"]
            section["watermark_step"] = summary["watermark_step"]
        return section
    except Exception:  # noqa: BLE001 - diagnostics only
        return None
