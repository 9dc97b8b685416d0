"""Transformer building blocks and Megatron-style model parallelism
(counterpart of ``apex_tpu.transformer``): ``parallel_state`` binds the
tp/pp/dp/cp groups, ``tensor_parallel`` holds the tp layers and
collectives, ``pipeline_parallel`` the collective pipeline schedules,
``context_parallel`` the ring and Ulysses attention over cp, ``moe`` the
routed experts and their all-to-all dispatch over ep."""

from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.log_util import set_logging_level

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType",
           "set_logging_level"]
