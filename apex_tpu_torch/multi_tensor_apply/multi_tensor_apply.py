"""Multi-tensor elementwise ops and reductions (port of
``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``).

- ``multi_tensor_scale``: out[i] = src[i] * scale;
- ``multi_tensor_axpby``: out[i] = a * x[i] + b * y[i];
- ``multi_tensor_l2norm`` (and ``_mp``): the global and per-tensor L2
  norms;
- ``multi_tensor_l2norm_scale``: the scale and the norms of its result
  in one call.

As in the JAX package, the ops return their outputs and an ``overflow``
flag (a bool 0-dim tensor on the tensors' device: any non-finite value
in the fp32 result) instead of writing an ``overflow_buf``; nothing here
waits for the device. Each list must hold one dtype, as the reference's
flat packing requires, but no concatenated copy is made: each tensor is
computed on its own, in fp32. Plain PyTorch: the JAX package computes
these with ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops.flat import FlatSpec


def _dtype_of(tensors: Sequence[torch.Tensor]) -> torch.dtype:
    """The list's one dtype (``FlatSpec.of`` refuses a mix)."""
    return FlatSpec.of(tensors).dtype


def _nonfinite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One bool: does any tensor hold a non-finite value."""
    if not tensors:
        return torch.zeros((), dtype=torch.bool)
    return ~torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def multi_tensor_scale(src_list, scale, out_dtype=None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``([src[i] * scale], overflow)`` (``multi_tensor_apply.py:38``),
    in ``out_dtype`` (default the list's own)."""
    dtype = out_dtype or _dtype_of(src_list)
    scaled = [t.float() * scale for t in src_list]
    return [s.to(dtype) for s in scaled], _nonfinite(scaled)


def multi_tensor_axpby(x_list, y_list, a=1.0, b=1.0, out_dtype=None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``([a * x[i] + b * y[i]], overflow)`` (``multi_tensor_apply.py:
    51``), in ``out_dtype`` (default the x list's dtype)."""
    dtype = out_dtype or _dtype_of(x_list)
    _dtype_of(y_list)
    out = [a * x.float() + b * y.float() for x, y in zip(x_list, y_list)]
    return [o.to(dtype) for o in out], _nonfinite(out)


def multi_tensor_l2norm(tensor_list: Sequence[torch.Tensor],
                        per_tensor: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Global (and optionally per-tensor) L2 norm, squares summed in fp32
    (``multi_tensor_apply.py:64``). Returns ``(global_norm,
    per_tensor_norms | None)`` as fp32 tensors. Each tensor is reduced on
    its own, so no concatenated copy of the list is made; the sums differ
    from one pass over the concatenation in order only."""
    if not tensor_list:
        zero = torch.zeros((), dtype=torch.float32)
        return zero, torch.zeros((0,)) if per_tensor else None
    squares = torch.stack([torch.sum(torch.square(t.float()))
                           for t in tensor_list])
    total = torch.sqrt(torch.sum(squares))
    return total, torch.sqrt(squares) if per_tensor else None


def multi_tensor_l2norm_mp(tensor_list, per_tensor: bool = False):
    """The mixed-precision entry point (``multi_tensor_apply.py:82``):
    squares accumulate in fp32 whatever the input dtype, as
    :func:`multi_tensor_l2norm` already does."""
    return multi_tensor_l2norm(tensor_list, per_tensor=per_tensor)


def multi_tensor_l2norm_scale(src_list, scale, per_tensor: bool = False):
    """``(out, norm, per_tensor_norms | None, overflow)``
    (``multi_tensor_apply.py:91``): ``out[i] = src[i] * scale`` in the
    list's dtype, and the norms of the fp32 products."""
    dtype = _dtype_of(src_list)
    scaled = [t.float() * scale for t in src_list]
    norm, per = multi_tensor_l2norm(scaled, per_tensor=per_tensor)
    return [s.to(dtype) for s in scaled], norm, per, _nonfinite(scaled)


class MultiTensorApply:
    """``multi_tensor_applier``'s shim (``multi_tensor_apply.py:108``):
    ``applier(op, overflow_buf, tensor_lists, *args)``. Apex passes the
    input and output lists together (scale ``[src, dst]``, axpby ``[x, y,
    out]``); each op's ``n_input_lists`` says how many lead, and the
    trailing output lists are ignored: the results and the overflow flag
    are returned, as in the JAX package. Chunking is accepted for parity
    and unused."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    @classmethod
    def check_avail(cls):
        """Never raises: the ops need no extension."""
        return None

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args):
        del noop_flag_buffer
        n_in = getattr(op, "n_input_lists", len(tensor_lists))
        return op(*tensor_lists[:n_in], *args)


# how many leading lists are inputs, in Apex's [inputs..., outputs...]
multi_tensor_scale.n_input_lists = 1  # [src, dst]
multi_tensor_axpby.n_input_lists = 2  # [x, y, out]
multi_tensor_l2norm.n_input_lists = 1
multi_tensor_l2norm_mp.n_input_lists = 1
multi_tensor_l2norm_scale.n_input_lists = 1

multi_tensor_applier = MultiTensorApply(2048 * 32)
