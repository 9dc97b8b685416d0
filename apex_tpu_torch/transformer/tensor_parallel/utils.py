"""Tensor-parallel helpers (port of
``apex_tpu/transformer/tensor_parallel/utils.py``)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from apex_tpu_torch.transformer.utils import divide


def split_tensor_along_last_dim(
    tensor: torch.Tensor, num_partitions: int,
    contiguous_split_chunks: bool = False
) -> List[torch.Tensor]:
    """Split along the last dim (ref utils.py:20); views of ``tensor``
    unless ``contiguous_split_chunks``."""
    last_dim_size = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, last_dim_size, dim=-1)
    if contiguous_split_chunks:
        return [c.contiguous() for c in chunks]
    return list(chunks)


class VocabUtility:
    """Vocab range bookkeeping for vocab-parallel embeddings/CE
    (ref utils.py:40)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
        per_partition_vocab_size: int, rank, world_size: int
    ) -> Tuple[int, int]:
        index_f = rank * per_partition_vocab_size
        index_l = index_f + per_partition_vocab_size
        return index_f, index_l

    @staticmethod
    def vocab_range_from_global_vocab_size(
        global_vocab_size: int, rank, world_size: int
    ) -> Tuple[int, int]:
        per_partition_vocab_size = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size, rank, world_size
        )
