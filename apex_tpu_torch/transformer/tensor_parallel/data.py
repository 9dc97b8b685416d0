"""Cross-rank data broadcast (port of
``apex_tpu/transformer/tensor_parallel/data.py``).

Every rank of a tensor-parallel group must see the same batch: the
reference's single controller hands every device the same arrays, and
CUDA Apex broadcasts tp-rank 0's. The port does the latter over the
group bound to ``"tp"`` when there is one (the tensors packed into one
flat buffer, one broadcast), after the reference's dtype check.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound


def _check_data_types(keys, data, target_dtype):
    """ref data.py:25."""
    for key in keys:
        if data[key].dtype != target_dtype:
            raise ValueError(
                f"{key} has data type {data[key].dtype}, "
                f"expected {target_dtype}"
            )


def _build_key_size_numel_dictionaries(keys, data):
    """ref data.py:34 — shapes and sizes bookkeeping."""
    key_size, key_numel, total_numel = {}, {}, 0
    for key in keys:
        key_size[key] = tuple(data[key].shape)
        key_numel[key] = data[key].numel()
        total_numel += key_numel[key]
    return key_size, key_numel, total_numel


def broadcast_data(keys: Sequence[str], data: Dict, datatype) -> Dict:
    """``{key: tensor}`` equal to tp-rank 0's on every rank of the
    tensor-parallel group (ref data.py:80)."""
    data = {k: torch.as_tensor(data[k]) for k in keys}
    _check_data_types(keys, data, datatype)
    key_size, key_numel, _ = _build_key_size_numel_dictionaries(keys, data)
    axis = parallel_state.TENSOR_AXIS
    if not _axis_bound(axis) or _backend.get_world_size(axis) == 1:
        return {k: data[k] for k in keys}
    flat = torch.cat([data[k].reshape(-1) for k in keys])
    flat = _backend.broadcast(flat, src=0, group=axis)
    out, offset = {}, 0
    for key in keys:
        out[key] = flat[offset:offset + key_numel[key]].view(key_size[key])
        offset += key_numel[key]
    return out
