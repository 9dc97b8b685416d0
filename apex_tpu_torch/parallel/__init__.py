"""Data parallelism (counterpart of ``apex_tpu.parallel``): DDP with
bucketed all-reduce overlapped with the backward, ZeRO-1 FusedAdam,
SyncBatchNorm and the launcher, over the process groups of
:mod:`apex_tpu_torch.distributed`.

``LARC`` / ``larc`` rescale each leaf's gradient by its layer-wise
adaptive rate before an inner optimizer's step. ``auto_shard`` (it
needs the reference's ``analysis/planner.py``) is not ported yet and
raises.
"""

import importlib

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    average_reduced,
    sync_autodiff_gradients,
    sync_gradients,
    sync_gradients_bucketed,
    sync_gradients_flat,
)
from apex_tpu_torch.parallel.larc import LARC, LARCState, larc
from apex_tpu_torch.parallel.overlap import (
    OverlapPlan,
    OverlapTrace,
    grad_sync_comms_bytes,
    overlapped_value_and_grad,
    plan_overlap,
    sync_gradients_overlapped,
)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
)
from apex_tpu_torch.parallel.zero import (
    Zero1AdamState,
    Zero1FusedAdam,
    zero1_fused_adam,
)


def create_syncbn_process_group(group_size, axis_name="data",
                                world_size=None):
    """Stats subgroups for SyncBatchNorm (ref ``parallel/__init__.py``
    ``create_syncbn_process_group``): ``group_size`` consecutive ranks of
    ``axis_name`` share statistics. Returns the ``(axis_name,
    group_size)`` pair to pass as ``SyncBatchNorm(process_group=...)``,
    or None for ``group_size`` 0 or the whole group; the size must divide
    the group's. ``world_size`` defaults to the size of ``axis_name``'s
    group."""
    from apex_tpu_torch.distributed import backend

    if world_size is None:
        world_size = backend.get_world_size(axis_name)
    if group_size == 0 or group_size == world_size:
        return None
    if group_size < 0 or world_size % group_size:
        raise ValueError(
            f"group_size={group_size} must be positive and divide the "
            f"axis size {world_size}")
    return (axis_name, int(group_size))


def _not_ported(name: str, waits_for: str):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: it waits for "
                                  f"{waits_for}")

    raise_not_ported.__name__ = name
    return raise_not_ported


def __getattr__(name):
    # the launcher is imported on use: ``python -m
    # apex_tpu_torch.parallel.multiproc`` must find it not yet imported
    if name == "multiproc":
        return importlib.import_module("apex_tpu_torch.parallel.multiproc")
    raise AttributeError(name)


auto_shard = _not_ported(
    "auto_shard", "the port of apex_tpu/analysis/planner.py (ROADMAP.md "
    "Queue 1 item 8)")

__all__ = [
    "DistributedDataParallel", "Reducer",
    "sync_gradients", "sync_gradients_flat", "sync_gradients_bucketed",
    "average_reduced", "sync_autodiff_gradients",
    "OverlapPlan", "OverlapTrace", "plan_overlap",
    "sync_gradients_overlapped", "overlapped_value_and_grad",
    "grad_sync_comms_bytes",
    "Zero1AdamState", "Zero1FusedAdam", "zero1_fused_adam",
    "SyncBatchNorm", "convert_syncbn_model", "create_syncbn_process_group",
    "LARC", "LARCState", "larc", "auto_shard", "multiproc",
]
