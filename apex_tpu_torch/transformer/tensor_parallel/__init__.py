"""Tensor-parallel building blocks (counterpart of
``apex_tpu.transformer.tensor_parallel``): the single-device path so
far."""

from apex_tpu_torch.transformer.tensor_parallel import cross_entropy, layers

vocab_parallel_cross_entropy = cross_entropy.vocab_parallel_cross_entropy
column_parallel_linear = layers.column_parallel_linear
row_parallel_linear = layers.row_parallel_linear
vocab_parallel_embedding = layers.vocab_parallel_embedding
