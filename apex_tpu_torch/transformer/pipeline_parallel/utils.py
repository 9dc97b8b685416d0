"""Pipeline training utilities (port of
``apex_tpu/transformer/pipeline_parallel/utils.py``)."""

from __future__ import annotations

from typing import List, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.amp.frontend import map_tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel._timers import (  # noqa: F401
    Timers,
    _Timer,
)

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None
_GLOBAL_AUTORESUME = None


def _ensure_var_is_initialized(var, name):
    if var is None:
        raise RuntimeError(f"{name} is not initialized")


def _ensure_var_is_not_initialized(var, name):
    if var is not None:
        raise RuntimeError(f"{name} is already initialized")


def listify_model(model) -> List:
    """ref utils.py:42."""
    return model if isinstance(model, list) else [model]


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """ref utils.py:58."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _ensure_var_is_not_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    )
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def _reconfigure_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """ref utils.py:72 (test/eval hook — replaces unconditionally)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_micro_batch_size() -> int:
    """ref utils.py:88."""
    _ensure_var_is_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    )
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.micro_batch_size


def get_num_microbatches() -> int:
    """ref utils.py:92."""
    _ensure_var_is_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    )
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    """ref utils.py:96."""
    _ensure_var_is_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    )
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True) -> None:
    """ref utils.py:100."""
    _ensure_var_is_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    )
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(
        consumed_samples, consistency_check
    )


def split_batch_into_microbatches(batch, micro_batch_size: int):
    """Reshape [B, ...] leaves to [M, mb, ...] for the schedules
    (ref utils.py:105 ``_split_batch_into_microbatch``)."""
    def split(x):
        b = x.shape[0]
        if b % micro_batch_size:
            raise ValueError(
                f"batch {b} not divisible by micro batch {micro_batch_size}"
            )
        return x.reshape((b // micro_batch_size, micro_batch_size)
                         + tuple(x.shape[1:]))

    return map_tree(split, batch)


def get_kth_microbatch(batch, k: int):
    """ref utils.py:122."""
    return map_tree(lambda x: x[k], batch)


def average_losses_across_data_parallel_group(losses):
    """The mean over the ``"dp"`` group of each loss, stacked (ref
    utils.py:242)."""
    stacked = torch.stack([torch.reshape(l, ()) for l in losses])
    if not _backend.is_bound(parallel_state.DATA_AXIS):
        return stacked
    return _backend.all_reduce(stacked, _backend.ReduceOp.AVG,
                               parallel_state.DATA_AXIS)


def param_is_not_shared(param) -> bool:
    """ref utils.py:181 — no shared-parameter aliasing in functional trees."""
    del param
    return True


def unwrap_model(model, module_instances=None):
    """ref utils.py:185 — unwrap DDP-style wrappers."""
    return_list = True
    if not isinstance(model, list):
        model = [model]
        return_list = False
    unwrapped = []
    for m in model:
        while hasattr(m, "module") and m.module is not None and (
            module_instances is None or isinstance(m, module_instances)
        ):
            inner = m.module
            if inner is m:
                break
            m = inner
        unwrapped.append(m)
    return unwrapped if return_list else unwrapped[0]


def calc_params_l2_norm(params, bf16: bool = True):
    """The params' L2 norm (ref utils.py:213): this rank's leaves in fp32.
    With ``"tp"`` or ``"pp"`` bound, the squares of the tensor-parallel
    leaves (marked by the tp layers, or every leaf of a tree of tensors)
    are summed over those groups."""
    del bf16
    leaves = (list(params.parameters()) if isinstance(params, torch.nn.Module)
              else _tree.leaves(params))
    sq = sum(torch.sum(torch.square(l.detach().float())) for l in leaves)
    sq = torch.as_tensor(sq)
    axes = tuple(a for a in (parallel_state.PIPELINE_AXIS,
                             parallel_state.TENSOR_AXIS)
                 if _backend.is_bound(a))
    if axes:
        sq = _backend.all_reduce(sq, _backend.ReduceOp.SUM, axes)
    return torch.sqrt(sq)


def get_ltor_masks_and_position_ids(
    data,
    eod_token: Optional[int] = None,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Left-to-right masks and position ids (ref utils.py:303):
    ``(attention_mask [1 or b, s, s] bool, loss_mask [b, s] fp32,
    position_ids [b, s])``. Per-document resets count the EOD tokens
    before each position."""
    b, s = data.shape
    device = data.device
    attention_mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                           device=device))[None]
    loss_mask = torch.ones((b, s), dtype=torch.float32, device=device)
    if eod_mask_loss and eod_token is not None:
        loss_mask = torch.where(data == eod_token,
                                torch.zeros_like(loss_mask), loss_mask)
    arange = torch.arange(s, device=device)
    position_ids = arange.expand(b, s)
    if (reset_position_ids or reset_attention_mask) and eod_token is not None:
        # document id = number of EODs strictly before each position
        is_eod = (data == eod_token).to(torch.int64)
        doc_id = torch.cumsum(is_eod, dim=1) - is_eod
        if reset_position_ids:
            # position restarts right after each EOD: the running max of
            # the index of the token after the latest EOD
            after = torch.roll(is_eod, 1, dims=1)
            after[:, 0] = 0
            starts = torch.where(after == 1, arange.expand(b, s),
                                 torch.zeros_like(after))
            seg_start = torch.cummax(starts, dim=1).values
            position_ids = arange[None] - seg_start
        if reset_attention_mask:
            same_doc = doc_id[:, :, None] == doc_id[:, None, :]
            attention_mask = attention_mask & same_doc
    return attention_mask, loss_mask, position_ids


# ------------------------------------------------------------------- timers


def _set_timers():
    global _GLOBAL_TIMERS
    _ensure_var_is_not_initialized(_GLOBAL_TIMERS, "timers")
    _GLOBAL_TIMERS = Timers()


def get_timers():
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = Timers()
    return _GLOBAL_TIMERS


def _process_rank() -> int:
    return _backend.get_rank() if _backend.is_initialized() else 0


def print_rank_0(message: str) -> None:
    """ref utils.py:159."""
    if _process_rank() == 0:
        print(message, flush=True)


def is_last_rank() -> bool:
    return _process_rank() == _backend.get_world_size() - 1


def print_rank_last(message):
    if is_last_rank():
        print(message, flush=True)


def report_memory(name: str) -> str:
    """Device memory of this rank (ref utils.py report_memory): allocated,
    its peak, and reserved, read through the memory observability tier
    (``device_memory_stats``); on a CPU rank a line that says so."""
    from apex_tpu_torch.observability.memory import device_memory_stats

    giga = 1024.0 ** 3
    if not torch.cuda.is_available():
        line = f"[{name}] memory on cpu: not tracked"
    else:
        dev = torch.cuda.current_device()
        stats = device_memory_stats(torch.device("cuda", dev))
        line = (f"[{name}] memory on cuda:{dev} | allocated "
                f"{stats['bytes_in_use'] / giga:.3f} GiB | peak "
                f"{stats['peak_bytes_in_use'] / giga:.3f} GiB | "
                f"reserved {stats['bytes_reserved'] / giga:.3f} GiB")
    print(line, flush=True)
    return line


def print_params_min_max_norm(optimizer, iteration: int) -> None:
    """Per-param (iteration, rank, index, model-parallel, min, max, norm)
    lines (ref utils.py print_params_min_max_norm). Takes an object with
    ``.params`` or a params tree or module."""
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        param_is_not_tensor_parallel_duplicate,
    )

    params = getattr(optimizer, "params", optimizer)
    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters())
    else:
        named = [(".".join(p), t) for p, t in zip(_tree.paths(params),
                                                  _tree.leaves(params))]
    rank = parallel_state.get_tensor_model_parallel_rank()
    for index, (path, leaf) in enumerate(named, start=1):
        mp = int(param_is_not_tensor_parallel_duplicate(leaf))
        x = leaf.detach().float()
        print(f"iteration, rank, index, model-parallel, min, max, norm: "
              f"{iteration} {rank} {index} {mp} "
              f"{float(x.min()):.6e} {float(x.max()):.6e} "
              f"{float(torch.linalg.vector_norm(x)):.6e}  {path}",
              flush=True)
