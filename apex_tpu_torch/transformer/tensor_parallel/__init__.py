"""Tensor-parallel building blocks (counterpart of
``apex_tpu.transformer.tensor_parallel``): the single-device path so
far."""

from apex_tpu_torch.transformer.tensor_parallel import cross_entropy

vocab_parallel_cross_entropy = cross_entropy.vocab_parallel_cross_entropy
