"""Stage-to-stage communication (port of
``apex_tpu/transformer/pipeline_parallel/p2p.py``).

The reference moves every stage's tensor to its neighbour with one
``ppermute`` over the ``'pp'`` axis: ranks with no sender receive zeros,
and the transpose of a +1 shift is a -1 shift. Here a shift is a
``torch.autograd.Function``: every rank of the group bound to the axis
(default ``"pp"``) posts its send to ``rank + delta`` and its receive
from ``rank - delta`` (``torch.distributed`` point-to-point), the edge
ranks of a non-cyclic shift get zeros, and the backward is the shift by
``-delta``. Every rank of the group must call each shift, in the same
order, forward and backward: a rank that skips one leaves its
neighbours waiting.

gloo's point-to-point ops take CPU tensors only, so for a gloo group a
CUDA tensor is staged through pinned host memory explicitly (copied out,
sent, received into pinned memory, copied back). An NCCL group sends
device tensors as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state


def _axis(axis_name: Optional[str]) -> str:
    return axis_name if axis_name is not None else parallel_state.PIPELINE_AXIS


def _staged(x: torch.Tensor, group) -> bool:
    """True when ``x`` must pass through host memory to cross ``group``:
    a CUDA tensor over gloo."""
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=True)
    out.copy_(x)
    return out


def shift_raw(x: torch.Tensor, group, delta: int,
              cyclic: bool) -> torch.Tensor:
    """Every rank's ``x`` at ``rank + delta`` of ``group`` (mod the size
    when ``cyclic``; else the edge ranks receive zeros). Not
    differentiable; :func:`_shift` is."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst, src = r + delta, r - delta
    if cyclic:
        dst, src = dst % n, src % n
    send = 0 <= dst < n
    recv = 0 <= src < n
    x = x.contiguous()
    if n == 1 or (not send and not recv):
        return x.clone() if (send and recv) else torch.zeros_like(x)
    staged = _staged(x, group)
    payload = _host(x) if staged and send else x
    buf = torch.empty(x.shape, dtype=x.dtype,
                      device="cpu" if staged else x.device,
                      pin_memory=staged)
    ops = []
    if send:
        ops.append(dist.P2POp(dist.isend, payload,
                              dist.get_global_rank(group, dst), group))
    if recv:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if not recv:
        return torch.zeros_like(x)
    return buf.to(x.device) if staged else buf


class _Shift(torch.autograd.Function):
    """``shift_raw`` forward, the opposite shift backward. ``anchor`` is
    a tensor that requires grad, so the node exists (and its backward
    collective runs) even when ``x`` does not require grad."""

    @staticmethod
    def forward(ctx, x, anchor, group, delta, cyclic):
        ctx.group, ctx.delta, ctx.cyclic = group, delta, cyclic
        return shift_raw(x, group, delta, cyclic)

    @staticmethod
    def backward(ctx, g):
        return (shift_raw(g, ctx.group, -ctx.delta, ctx.cyclic), None,
                None, None, None)


def _group_of(axis_name: Optional[str]):
    axis = _axis(axis_name)
    return _backend.get_group(axis) if _backend.is_bound(axis) else None


def _apply_shift(x, delta, axis_name, cyclic, anchor=None):
    group = _group_of(axis_name)
    if group is None:  # one stage: nobody sends
        return x.clone() if cyclic else torch.zeros_like(x)
    if anchor is None and not x.requires_grad:
        return shift_raw(x, group, delta, cyclic)
    if anchor is None:
        anchor = x
    return _Shift.apply(x, anchor, group, delta, cyclic)


def _shift(x, delta: int, axis_name: Optional[str] = None, anchor=None):
    """Every stage's ``x`` to rank + delta (non-cyclic: edge ranks
    receive zeros), differentiable (ref p2p.py:31)."""
    return _apply_shift(x, delta, axis_name, False, anchor)


def _shift_cyclic(x, delta: int, axis_name: Optional[str] = None,
                  anchor=None):
    """Cyclic shift (the interleaved schedule's ring, ref p2p.py:42)."""
    return _apply_shift(x, delta, axis_name, True, anchor)


def send_forward_recv_forward(output_tensor, axis_name: Optional[str] = None):
    """Push activations one stage downstream; returns what arrived from the
    previous stage (ref p2p_communication.py:337)."""
    return _shift(output_tensor, +1, axis_name)


def send_backward_recv_backward(input_grad, axis_name: Optional[str] = None):
    """Push gradients one stage upstream (ref p2p_communication.py:361)."""
    return _shift(input_grad, -1, axis_name)


def send_forward(output_tensor, axis_name: Optional[str] = None):
    """A lone send is still the paired shift: the result is meaningful on
    the receiving ranks (ref p2p_communication.py:237)."""
    return _shift(output_tensor, +1, axis_name)


def recv_forward(output_tensor, axis_name: Optional[str] = None):
    """:func:`send_forward` from the receiver's side (ref
    p2p_communication.py:187): every stage gets its predecessor's
    ``output_tensor``."""
    return _shift(output_tensor, +1, axis_name)


def send_backward(input_grad, axis_name: Optional[str] = None):
    """ref p2p_communication.py:263."""
    return _shift(input_grad, -1, axis_name)


def recv_backward(input_grad, axis_name: Optional[str] = None):
    """ref p2p_communication.py:213."""
    return _shift(input_grad, -1, axis_name)


def send_forward_recv_backward(output_tensor, input_grad,
                               axis_name: Optional[str] = None):
    """Both directions (ref p2p_communication.py:287): ``(the grad from
    the next stage, the activation from the previous one)``."""
    return (_shift(input_grad, -1, axis_name),
            _shift(output_tensor, +1, axis_name))


def send_backward_recv_forward(input_grad, output_tensor,
                               axis_name: Optional[str] = None):
    """ref p2p_communication.py:312."""
    return (_shift(output_tensor, +1, axis_name),
            _shift(input_grad, -1, axis_name))


def send_forward_backward_recv_forward_backward(
    output_tensor, input_grad, axis_name: Optional[str] = None
):
    """ref p2p_communication.py:385."""
    return (_shift(output_tensor, +1, axis_name),
            _shift(input_grad, -1, axis_name))


def embedding_allreduce(grad, axis_name: Optional[str] = None):
    """Sum embedding grads between the first and last stage (the
    reference's embedding-group all-reduce, ref parallel_state.py:301):
    every stage takes part, the others contributing zeros and keeping
    their own ``grad``."""
    axis = _axis(axis_name)
    if not _backend.is_bound(axis):
        return grad
    n, r = _backend.get_world_size(axis), _backend.get_rank(axis)
    is_member = r == 0 or r == n - 1
    masked = grad if is_member else torch.zeros_like(grad)
    total = _backend.all_reduce(masked, _backend.ReduceOp.SUM, axis)
    return total if is_member else grad
