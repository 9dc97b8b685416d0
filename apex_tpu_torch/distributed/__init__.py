"""Process groups and collectives (counterpart of
``apex_tpu.distributed``).

The reference's group is a named mesh axis and its collectives are XLA's;
here a name is bound to a ``torch.distributed`` process group (NCCL for
CUDA tensors, gloo for CPU tensors or for several ranks on one GPU), and
the collectives are ``torch.distributed``'s.
"""

from apex_tpu_torch.distributed.backend import (
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    bind,
    broadcast,
    destroy_process_group,
    get_group,
    get_rank,
    get_world_size,
    init_process_group,
    is_initialized,
    new_group,
    reduce_scatter,
)
from apex_tpu_torch.distributed.divergence import (
    DivergenceMonitor,
    DivergenceState,
    assert_replicas_equal,
    replica_divergence,
)

__all__ = [
    "all_gather", "all_reduce", "all_to_all", "barrier", "bind",
    "broadcast", "destroy_process_group", "get_group", "get_rank",
    "get_world_size", "init_process_group", "is_initialized", "new_group",
    "reduce_scatter", "ReduceOp",
    "DivergenceMonitor", "DivergenceState", "assert_replicas_equal",
    "replica_divergence",
]
