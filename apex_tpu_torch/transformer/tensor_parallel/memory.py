"""Flat memory buffers (port of
``apex_tpu/transformer/tensor_parallel/memory.py``, itself of the CUDA
reference's ``apex/transformer/tensor_parallel/memory.py``).

A :class:`MemoryBuffer` is one flat tensor allocated once, with
bump-pointer bookkeeping: :meth:`MemoryBuffer.add` reserves a region and
returns its flat offsets, :meth:`MemoryBuffer.get` views a region as a
shape and :meth:`MemoryBuffer.put` writes one. As in the CUDA reference,
``get`` is a view into the buffer, not a copy (the JAX reference returns
a copy because its arrays are immutable); ``put`` writes in place and
returns the buffer. Buffers are made on the GPU unless ``device="cpu"``
is asked for.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apex_tpu_torch import _device

_MEM_BUFFS: Dict[str, "MemoryBuffer"] = {}


def allocate_mem_buff(name, numel, dtype, track_usage,
                      device: _device.DeviceLike = None) -> "MemoryBuffer":
    """A new buffer registered under ``name`` (ref memory.py:23); a name
    already registered raises."""
    if name in _MEM_BUFFS:
        raise ValueError(f"memory buffer {name} already allocated")
    _MEM_BUFFS[name] = MemoryBuffer(name, numel, dtype, track_usage, device)
    return _MEM_BUFFS[name]


def get_mem_buff(name) -> Optional["MemoryBuffer"]:
    """The buffer registered under ``name``, or None (ref memory.py:30)."""
    return _MEM_BUFFS.get(name)


def reset_mem_buffs() -> None:
    """Forget every registered buffer."""
    _MEM_BUFFS.clear()


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class MemoryBuffer:
    """Flat buffer with bump-pointer allocation (ref memory.py:35)."""

    def __init__(self, name, numel, dtype, track_usage=False,
                 device: _device.DeviceLike = None):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros((numel,), dtype=dtype,
                                device=_device.resolve(device))
        self._start = 0
        self.track_usage = track_usage
        self.in_use_value = 0.0
        self.total_value = 0.0

    def reset(self) -> None:
        """Free every region (the data stays as it is)."""
        self._start = 0
        if self.track_usage:
            self.total_value += float(self.numel)
            self.in_use_value = 0.0

    def is_in_use(self) -> bool:
        return self._start > 0

    def allocated(self) -> int:
        return self._start

    def add(self, shape):
        """Reserve a region of ``shape``'s size; returns its (start, stop)
        flat offsets. Raises ``MemoryError`` when it does not fit."""
        numel = _numel(shape)
        if self._start + numel > self.numel:
            raise MemoryError(
                f"buffer {self.name} out of space "
                f"({self._start}+{numel} > {self.numel})")
        start = self._start
        self._start += numel
        if self.track_usage:
            self.in_use_value += float(numel)
        return start, start + numel

    def get(self, shape, start: int) -> torch.Tensor:
        """The region at ``start`` viewed as ``shape`` (a view: writes to
        it write the buffer)."""
        numel = _numel(shape)
        return self.data[start:start + numel].view(tuple(shape))

    def put(self, value, start: int) -> torch.Tensor:
        """Write ``value`` (cast to the buffer's dtype) into the region
        at ``start``; returns the buffer."""
        flat = torch.as_tensor(value).reshape(-1)
        self.data[start:start + flat.numel()] = flat.to(self.dtype)
        return self.data

    def print_average_usage(self) -> None:
        if not self.track_usage:
            return
        if self.total_value:
            print(f"buffer {self.name} average usage: "
                  f"{100.0 * self.in_use_value / self.total_value:.2f}%")


class RingMemBuffer:
    """Round-robin set of memory buffers (ref memory.py:133)."""

    def __init__(self, name, num_buffers, numel, dtype, track_usage,
                 device: _device.DeviceLike = None):
        self.num_buffers = num_buffers
        self.buffers = [
            allocate_mem_buff(f"{name}-{i}", numel, dtype, track_usage,
                              device)
            for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        self._index = (self._index + 1) % self.num_buffers
        buff = self.buffers[self._index]
        if buff.is_in_use():
            raise RuntimeError("next ring buffer is still in use")
        return buff
