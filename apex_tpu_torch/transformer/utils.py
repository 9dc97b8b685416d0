"""Transformer-wide utilities (port of ``apex_tpu/transformer/utils.py``).

``split_tensor_into_1d_equal_chunks`` / ``gather_split_1d_tensor`` move
flat shards between the ranks of the tensor-parallel group.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.distributed import backend as _backend


def ensure_divisibility(numerator: int, denominator: int) -> None:
    """Raise unless numerator is divisible by denominator (ref utils.py:7)."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division (ref utils.py:14)."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_into_1d_equal_chunks(tensor: torch.Tensor,
                                      axis_name: str = "tp") -> torch.Tensor:
    """This rank's equal flat chunk of the (replicated) full ``tensor``
    (ref utils.py:21); the group is the one bound to ``axis_name``."""
    n = _backend.get_world_size(axis_name)
    rank = _backend.get_rank(axis_name)
    flat = tensor.reshape(-1)
    chunk = flat.shape[0] // n
    return flat[rank * chunk:(rank + 1) * chunk]


def gather_split_1d_tensor(tensor: torch.Tensor,
                           axis_name: str = "tp") -> torch.Tensor:
    """All-gather flat shards back into the full 1-D tensor (ref utils.py:32)."""
    return _backend.all_gather(tensor, axis_name, axis=0, tiled=True)


def cast_if_needed(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype`` when set."""
    return x if dtype is None else x.to(dtype)
