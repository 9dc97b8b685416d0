"""Pipeline parallelism over the ``"pp"`` group (counterpart of
``apex_tpu.transformer.pipeline_parallel``)."""

from apex_tpu_torch.transformer.pipeline_parallel import p2p
from apex_tpu_torch.transformer.pipeline_parallel import utils
from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    ExperimentalWarning,
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    get_params_for_weight_decay_optimization,
    pipelined_forward,
    pipelined_forward_interleaved,
)

# parity alias for the reference module name
p2p_communication = p2p

__all__ = [
    "p2p",
    "p2p_communication",
    "utils",
    "Timers",
    "ExperimentalWarning",
    "build_model",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "get_forward_backward_func",
    "get_params_for_weight_decay_optimization",
    "pipelined_forward",
    "pipelined_forward_interleaved",
]
