"""The halo-exchange strategies (port of
``apex_tpu/contrib/halo_exchangers.py``; ref apex/contrib/bottleneck/
halo_exchangers.py ``HaloExchanger{NoComm, AllGather, SendRecv, Peer}``).

Each strategy computes the same neighbour shift over the group bound to
``axis_name``: a rank receives its left neighbour's right edge and its
right neighbour's left edge; the first rank's left input and the last
rank's right input are zeros. SendRecv (and Peer, which only accepts the
reference's extra knobs) is the pipeline's point-to-point shift
(``transformer/pipeline_parallel/p2p.py``); AllGather gathers every
rank's edges and picks the neighbours'; NoComm hands a rank's own edges
back swapped. All are differentiable.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.distributed import backend
from apex_tpu_torch.transformer.pipeline_parallel.p2p import _shift

__all__ = [
    "HaloExchanger", "HaloExchangerNoComm", "HaloExchangerAllGather",
    "HaloExchangerSendRecv", "HaloExchangerPeer",
    "left_right_halo_exchange",
]


def left_right_halo_exchange(left_output_halo, right_output_halo,
                             axis_name: str = "spatial"):
    """``(left_input_halo, right_input_halo)``: the left neighbour's
    ``right_output_halo`` and the right neighbour's ``left_output_halo``
    (ref ``:27-43``); zeros at the boundary ranks. Every rank of the
    group must call it."""
    left_input = _shift(right_output_halo, 1, axis_name)
    right_input = _shift(left_output_halo, -1, axis_name)
    return left_input, right_input


class HaloExchanger:
    """Base (ref ``:46``): ``axis_name`` stands for the reference's
    (spatial_group_size, rank) pair."""

    def __init__(self, spatial_group_size=None, rank=None,
                 axis_name: str = "spatial"):
        del spatial_group_size, rank
        self.axis_name = axis_name

    def left_right_halo_exchange(self, left_output_halo,
                                 right_output_halo):
        raise NotImplementedError


class HaloExchangerNoComm(HaloExchanger):
    """ref ``:60``: no communication, a rank's own edges come back
    swapped (one rank, or debugging)."""

    def __init__(self, world_size=None, spatial_group_size=None, rank=None,
                 comm=None, axis_name: str = "spatial"):
        super().__init__(spatial_group_size, rank, axis_name)
        del world_size, comm

    def left_right_halo_exchange(self, left_output_halo,
                                 right_output_halo):
        return right_output_halo, left_output_halo


class HaloExchangerAllGather(HaloExchanger):
    """ref ``:74``: every rank's edges gathered, the neighbours' picked;
    the boundary ranks' missing inputs are zeros, as the shift's."""

    def __init__(self, world_size=None, spatial_group_size=None, rank=None,
                 comm=None, axis_name: str = "spatial"):
        super().__init__(spatial_group_size, rank, axis_name)
        del world_size, comm

    def left_right_halo_exchange(self, left_output_halo,
                                 right_output_halo):
        ax = self.axis_name
        if not (backend.is_initialized() and backend.is_bound(ax)):
            return (torch.zeros_like(right_output_halo),
                    torch.zeros_like(left_output_halo))
        n, rank = backend.get_world_size(ax), backend.get_rank(ax)
        rights = backend.all_gather(right_output_halo, ax, tiled=False)
        lefts = backend.all_gather(left_output_halo, ax, tiled=False)
        # both gathers stay in every rank's graph (torch.where, as the
        # reference's jnp.where), so every rank runs both backwards
        zero = torch.zeros((), dtype=rights.dtype, device=rights.device)
        left_input = torch.where(
            torch.tensor(rank > 0, device=rights.device),
            rights[max(rank - 1, 0)], zero)
        right_input = torch.where(
            torch.tensor(rank < n - 1, device=lefts.device),
            lefts[min(rank + 1, n - 1)], zero)
        return left_input, right_input


class HaloExchangerSendRecv(HaloExchanger):
    """ref ``:104``: the pairwise neighbour transfer."""

    def __init__(self, world_size=None, spatial_group_size=None, rank=None,
                 comm=None, axis_name: str = "spatial"):
        super().__init__(spatial_group_size, rank, axis_name)
        del world_size, comm

    def left_right_halo_exchange(self, left_output_halo,
                                 right_output_halo):
        return left_right_halo_exchange(left_output_halo,
                                        right_output_halo, self.axis_name)


class HaloExchangerPeer(HaloExchangerSendRecv):
    """ref ``:119``: CUDA peer memory in the reference; here SendRecv
    with the reference's extra knobs accepted."""

    def __init__(self, world_size=None, spatial_group_size=None, rank=None,
                 comm=None, peer_pool=None, explicit_nhwc=False, numSM=1,
                 axis_name: str = "spatial"):
        super().__init__(world_size, spatial_group_size, rank, comm,
                         axis_name=axis_name)
        del peer_pool, explicit_nhwc, numSM
