"""Tensor-parallel linear layers and embedding, single-device path (port
of the per-shard functions of
``apex_tpu/transformer/tensor_parallel/layers.py``).

With no tensor-parallel axis bound the reference's collectives are
identities: a column- or row-parallel linear is a product plus a bias,
and the vocab-parallel embedding is a gather. The products are
``torch.matmul``, which on the GPU is a bf16 product with an fp32
accumulator, as the reference's ``matmul_amp`` -> ``matmul_fp32acc`` is
outside the O4 fp8 tier (``ops/precision.py:59,280``). A bound axis
raises until the multi-GPU slice ports the process groups.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _single_device(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"tensor-parallel axis {axis_name!r}: only the single-device "
            f"path (axis_name=None) is ported")


def column_parallel_linear(x: torch.Tensor, kernel: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           axis_name: Optional[str] = None) -> torch.Tensor:
    """``x @ kernel + bias``, kernel ``(in, out)`` (``layers.py:321``; on
    one shard ``gather_output`` is the identity)."""
    _single_device(axis_name)
    y = torch.matmul(x, kernel)
    return y + bias if bias is not None else y


def row_parallel_linear(x: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        axis_name: Optional[str] = None) -> torch.Tensor:
    """``x @ kernel + bias``, kernel ``(in, out)`` (``layers.py:341``; on
    one shard ``input_is_parallel`` and the reduction are identities)."""
    _single_device(axis_name)
    y = torch.matmul(x, kernel)
    return y + bias if bias is not None else y


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor,
                             axis_name: Optional[str] = None) -> torch.Tensor:
    """Rows of ``table`` [vocab, hidden] at ``ids`` (``layers.py:366``)."""
    _single_device(axis_name)
    return F.embedding(ids, table)
