"""Tensor parallelism over the ``"tp"`` group (counterpart of
``apex_tpu.transformer.tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    copy_tensor_model_parallel_attributes,
    linear_with_grad_accumulation_and_async_allreduce,
    param_is_not_tensor_parallel_duplicate,
    param_partition_specs,
    row_parallel_linear,
    set_defaults_if_not_set_tensor_model_parallel_attributes,
    set_tensor_model_parallel_attributes,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    reduce_scatter_to_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.memory import (
    MemoryBuffer,
    RingMemBuffer,
    allocate_mem_buff,
    get_mem_buff,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    CudaRNGStatesTracker,
    RNGStatesTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_rng_seed,
    tp_rank_key,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    split_tensor_along_last_dim,
)

__all__ = [
    "vocab_parallel_cross_entropy",
    "broadcast_data",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "column_parallel_linear",
    "row_parallel_linear",
    "vocab_parallel_embedding",
    "linear_with_grad_accumulation_and_async_allreduce",
    "copy_tensor_model_parallel_attributes",
    "param_is_not_tensor_parallel_duplicate",
    "set_defaults_if_not_set_tensor_model_parallel_attributes",
    "param_partition_specs",
    "set_tensor_model_parallel_attributes",
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "reduce_scatter_to_tensor_model_parallel_region",
    "MemoryBuffer",
    "RingMemBuffer",
    "allocate_mem_buff",
    "get_mem_buff",
    "RNGStatesTracker",
    "CudaRNGStatesTracker",
    "checkpoint",
    "get_rng_tracker",
    "get_cuda_rng_tracker",
    "model_parallel_rng_seed",
    "model_parallel_cuda_manual_seed",
    "tp_rank_key",
    "VocabUtility",
    "split_tensor_along_last_dim",
]
