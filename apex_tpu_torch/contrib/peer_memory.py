"""Peer-memory halo exchange (port of ``apex_tpu/contrib/peer_memory.py``;
ref apex/contrib/peer_memory/{peer_memory, peer_halo_exchanger_1d}.py).

The reference moves a convolution's halo rows between GPUs through
cudaIpc peer mappings; the JAX package sends them with a ``ppermute``
pair. Here the neighbour shift is the pipeline's
(``transformer/pipeline_parallel/p2p.py``: ``torch.distributed``
point-to-point over the group bound to ``axis_name``, edge ranks
receiving zeros, CUDA tensors staged through pinned host memory on a
gloo group), differentiable: its backward shifts the other way.
``PeerMemoryPool`` has nothing to pre-allocate and hands back zeros.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend
from apex_tpu_torch.transformer.pipeline_parallel.p2p import _shift

__all__ = ["PeerHaloExchanger1d", "PeerMemoryPool", "halo_exchange_1d"]


class PeerMemoryPool:
    """API-parity facade (ref ``peer_memory.py`` PeerMemoryPool):
    ``allocate_peer_tensors`` hands back zeros of the shape on
    ``device`` (default: the GPU, raising when there is none)."""

    def __init__(self, static_size: int = 0, dynamic_size: int = 0,
                 peer_ranks=None, device: _device.DeviceLike = None):
        del static_size, dynamic_size
        self.peer_ranks = peer_ranks
        self.device = device

    def allocate_peer_tensors(self, shape, dtype, channels_last, dynamic):
        del dynamic
        t = torch.zeros(shape, dtype=dtype,
                        device=_device.resolve(self.device))
        if channels_last and t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return [t]

    def reset(self):
        pass


def _group_shape(axis_name: str):
    """``(size, rank)`` of the group bound to ``axis_name``; ``(1, 0)``
    when none is (every rank a boundary: nothing is exchanged)."""
    if backend.is_initialized() and backend.is_bound(axis_name):
        return (backend.get_world_size(axis_name),
                backend.get_rank(axis_name))
    return 1, 0


def halo_exchange_1d(y: torch.Tensor, half_halo: int,
                     axis_name: str = "spatial", h_dim: int = 1):
    """``y`` with its ``half_halo`` margins along ``h_dim`` filled from
    the neighbours over ``axis_name`` (ref ``:36-76``,
    ``peer_halo_exchanger_1d.py:14`` with ``H_split``).

    ``y``: the local slab with its margins in place (``[N, H_local + 2 hh,
    W, C]`` for ``h_dim`` 1). The top margin takes the previous rank's
    last interior rows, the bottom margin the next rank's first; the
    first rank keeps its top margin, the last its bottom, as the
    reference does. Every rank of the group must call it."""
    hh = half_halo
    n, rank = _group_shape(axis_name)
    size = y.shape[h_dim]
    top_edge = y.narrow(h_dim, hh, hh)
    bot_edge = y.narrow(h_dim, size - 2 * hh, hh)
    # both shifts run on every rank, in this order, and both results stay
    # in the graph (torch.where, as the reference's jnp.where), so every
    # rank runs both backward shifts
    from_next = _shift(top_edge, -1, axis_name)
    from_prev = _shift(bot_edge, 1, axis_name)
    first = torch.tensor(rank == 0, device=y.device)
    last = torch.tensor(rank == n - 1, device=y.device)
    top = torch.where(first, y.narrow(h_dim, 0, hh), from_prev)
    bot = torch.where(last, y.narrow(h_dim, size - hh, hh), from_next)
    return torch.cat([top, y.narrow(h_dim, hh, size - 2 * hh), bot],
                     dim=h_dim)


class PeerHaloExchanger1d:
    """ref ``peer_halo_exchanger_1d.py:5``; the rank, group size and pool
    are the group bound to ``axis_name``."""

    def __init__(self, rank=None, peer_group_size=None, peer_pool=None,
                 half_halo: int = 1, axis_name: str = "spatial"):
        del rank, peer_group_size, peer_pool
        self.half_halo = half_halo
        self.axis_name = axis_name

    def __call__(self, y, H_split: bool = True, explicit_nhwc: bool = True,
                 numSM: int = 1, diagnostics: bool = False):
        del explicit_nhwc, numSM, diagnostics
        return halo_exchange_1d(y, self.half_halo, self.axis_name,
                                1 if H_split else 2)
