"""Per-tensor amax history rings (port of
``apex_tpu/observability/numerics/history.py``).

Delayed scaling ("FP8 Formats for Deep Learning", Micikevicius et al.)
takes each tensor's fp8 scale from the max of its last H observed amaxes
rather than this step's. :class:`AmaxHistory` keeps the rings of n
tensors as one fp32 ``[n, H]`` tensor on the device and a shared cursor,
so a step's update is one column write of the stacked amax vector.

The state is a NamedTuple of tensors (:class:`AmaxHistoryState`): the
ring lives on the device the caller names (the GPU unless the CPU is
asked for); ``cursor`` and ``filled`` are int32 0-dim tensors on the
CPU, as the port's optimizer step counters are, so the column to write
is known on the host without waiting for the device. ``update`` is
functional: it returns a new state and leaves the old one as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from apex_tpu_torch import _device

__all__ = [
    "F8_E4M3_MAX", "F8_E5M2_MAX", "AmaxHistoryState", "AmaxHistory",
]

#: largest magnitudes of the fp8 formats the delayed scales target (E4M3
#: for forward operands, E5M2 for gradients)
F8_E4M3_MAX = 448.0
F8_E5M2_MAX = 57344.0


class AmaxHistoryState(NamedTuple):
    """Ring state; carry it with the rest of the train state."""

    ring: torch.Tensor    # fp32 [n, H] per-tensor amax ring, on the device
    cursor: torch.Tensor  # int32 0-dim on the CPU: next column to write
    filled: torch.Tensor  # int32 0-dim on the CPU: columns written (<= H)


class AmaxHistory:
    """Fixed-structure amax rings for the tensors named by ``paths``. The
    object is static configuration; all mutable state lives in
    :class:`AmaxHistoryState`."""

    def __init__(self, paths: Sequence[str], length: int = 16):
        if length < 1:
            raise ValueError(f"history length must be >= 1, got {length}")
        self.paths = tuple(str(p) for p in paths)
        self.length = int(length)

    def index(self, path: str) -> int:
        return self.paths.index(path)

    def init(self, device: _device.DeviceLike = None) -> AmaxHistoryState:
        """Empty rings on ``device`` (default: the GPU, raising when
        there is none)."""
        return AmaxHistoryState(
            ring=torch.zeros((len(self.paths), self.length),
                             dtype=torch.float32,
                             device=_device.resolve(device)),
            cursor=torch.zeros((), dtype=torch.int32),
            filled=torch.zeros((), dtype=torch.int32))

    def update(self, state: AmaxHistoryState, amax) -> AmaxHistoryState:
        """Write one step's stacked amax vector (fp32 ``[n]``) into the
        rings: one column write, into a new ring."""
        # the cursor and the fill count stay 0-dim CPU tensors, read by the
        # ops as scalars (no host read: a traced step keeps them in its
        # graph)
        col = torch.arange(self.length, device=state.ring.device) \
            == state.cursor
        ring = torch.where(col[None, :], torch.as_tensor(
            amax, dtype=torch.float32, device=state.ring.device)[:, None],
            state.ring)
        return AmaxHistoryState(
            ring=ring, cursor=(state.cursor + 1) % self.length,
            filled=torch.clamp(state.filled + 1, max=self.length))

    def amax(self, state: AmaxHistoryState) -> torch.Tensor:
        """Rolling per-tensor amax over the filled slots (fp32 ``[n]``).
        Unfilled slots never vote (amax >= 0, so masking them to 0 is
        exact); an empty history reports 0."""
        mask = torch.arange(self.length, device=state.ring.device) \
            < state.filled
        return torch.amax(torch.where(mask[None, :], state.ring,
                                      torch.zeros_like(state.ring)), dim=1)

    def scales(self, state: AmaxHistoryState, fp8_max: float = F8_E4M3_MAX,
               margin: float = 0.0) -> torch.Tensor:
        """Per-tensor delayed scale ``fp8_max / (rolling_amax * 2^margin)``
        (fp32 ``[n]``); tensors with no signal yet (rolling amax 0) scale
        by 1. The quotient is a tensor division, one rounding, as the
        reference divides."""
        rolling = self.amax(state) * (2.0 ** margin)
        tiny = torch.finfo(torch.float32).tiny
        return torch.where(rolling > 0.0,
                           torch.full_like(rolling, fp8_max)
                           / torch.clamp(rolling, min=tiny),
                           torch.ones_like(rolling))

    def state_dict(self, state: AmaxHistoryState) -> dict:
        """Plain-Python form (the reference's), so a dict either package
        wrote loads into the other."""
        return {"paths": list(self.paths), "length": self.length,
                "ring": state.ring.tolist(), "cursor": int(state.cursor),
                "filled": int(state.filled)}

    def load_state_dict(self, d: dict, device: _device.DeviceLike = None
                        ) -> AmaxHistoryState:
        if tuple(d.get("paths", ())) != self.paths:
            raise ValueError(
                "amax-history state was recorded for a different tensor "
                f"set; refusing to misalign rings ({len(d.get('paths', ()))}"
                f" recorded vs {len(self.paths)} configured paths)")
        if int(d.get("length", self.length)) != self.length:
            raise ValueError(f"amax-history length mismatch: state has "
                             f"{d.get('length')}, configured {self.length}")
        return AmaxHistoryState(
            ring=torch.tensor(d["ring"], dtype=torch.float32,
                              device=_device.resolve(device)).reshape(
                len(self.paths), self.length),
            cursor=torch.tensor(int(d["cursor"]), dtype=torch.int32),
            filled=torch.tensor(int(d["filled"]), dtype=torch.int32))
