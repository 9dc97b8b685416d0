"""Tensor-, pipeline-, context- and data-parallel process groups over
``torch.distributed`` (port of ``apex_tpu/transformer/parallel_state.py``).

The reference lays its devices out on one mesh with the axes
``('pp', 'dp', 'cp', 'tp')`` and names a group by its axis. Here the
world is ``torch.distributed``'s: :func:`initialize_model_parallel`
splits it into the same grid, with the reference's rank order (tp
fastest, then cp, then dp, pp outermost: global rank
``((pp * dp_size + dp) * cp_size + cp) * tp_size + tp``,
``parallel_state.py:93``), makes one ``torch.distributed`` group for
every line of ranks along each axis and binds each to its axis name
through :func:`apex_tpu_torch.distributed.backend.new_group`. So a rank
holds the reference's shard coordinate for coordinate, and the group
getters return the axis names that the port's collectives resolve.

Rank getters return this process's index along the axis (the reference
returns the traced ``axis_index`` inside ``shard_map``); the ``set_*``
overrides win, as they do in the reference. Before
:func:`initialize_model_parallel` they return 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from apex_tpu_torch.distributed import backend as _backend

# Canonical axis names.
PIPELINE_AXIS = "pp"
DATA_AXIS = "dp"
CONTEXT_AXIS = "cp"
TENSOR_AXIS = "tp"
AXES = (PIPELINE_AXIS, DATA_AXIS, CONTEXT_AXIS, TENSOR_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid of ranks: each axis's size, in the reference's axis order
    (``Mesh.shape`` as JAX's mesh gives it)."""

    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def rank_of(self, **coords) -> int:
        """The global rank at ``coords`` (an axis left out is 0)."""
        r = 0
        for axis in self.axis_names:
            r = r * self.shape[axis] + int(coords.get(axis, 0))
        return r


_MESH: Optional[Mesh] = None
_VIRTUAL_PIPELINE_WORLD_SIZE: Optional[int] = None
_VIRTUAL_PIPELINE_RANK: Optional[int] = None
_PIPELINE_SPLIT_RANK: Optional[int] = None

# Overrides (ref parallel_state.py:378-443 set_* hooks).
_OVERRIDES: dict = {}


def is_unitialized() -> bool:
    """(sic — the reference misspells it too, ref parallel_state.py:68)"""
    return _MESH is None


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    *,
    context_parallel_size_: int = 1,
    backend: Optional[str] = None,
) -> Mesh:
    """Split the ``torch.distributed`` world into the grid and bind its
    groups (ref ``parallel_state.py:73``). Every rank must call it, with
    the same sizes. The data-parallel size is world // (tp * pp * cp);
    ``"dp"`` and ``"data"`` are rebound from the world to the
    data-parallel group. ``backend`` is the groups' backend (default the
    world's)."""
    global _MESH, _VIRTUAL_PIPELINE_WORLD_SIZE, _VIRTUAL_PIPELINE_RANK
    global _PIPELINE_SPLIT_RANK
    if not _backend.is_initialized():
        raise RuntimeError(
            "initialize_model_parallel needs a started torch.distributed "
            "world (apex_tpu_torch.distributed.init_process_group)")
    world = _backend.get_world_size()
    tp = tensor_model_parallel_size_
    pp = pipeline_model_parallel_size_
    cp = context_parallel_size_
    if world % (tp * pp * cp) != 0:
        raise RuntimeError(
            f"world size {world} not divisible by tp({tp})*pp({pp})*cp({cp})"
        )
    dp = world // (tp * pp * cp)
    mesh = Mesh({PIPELINE_AXIS: pp, DATA_AXIS: dp, CONTEXT_AXIS: cp,
                 TENSOR_AXIS: tp})
    # one group per line of ranks along each axis; every rank creates
    # every group, in the same order (torch.distributed.new_group)
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        for rest in _grid(mesh, others):
            ranks = [mesh.rank_of(**rest, **{axis: i})
                     for i in range(mesh.shape[axis])]
            _backend.new_group(axis, ranks, backend=backend)
    _backend.bind("data", _backend.get_group(DATA_AXIS))
    _MESH = mesh
    if virtual_pipeline_model_parallel_size_ is not None:
        _VIRTUAL_PIPELINE_WORLD_SIZE = virtual_pipeline_model_parallel_size_
        _VIRTUAL_PIPELINE_RANK = 0
    else:
        _VIRTUAL_PIPELINE_WORLD_SIZE = None
        _VIRTUAL_PIPELINE_RANK = None
    _PIPELINE_SPLIT_RANK = pipeline_model_parallel_split_rank_
    return _MESH


def _grid(mesh: Mesh, axes):
    """Every assignment of coordinates to ``axes``, in row-major order."""
    out = [{}]
    for axis in axes:
        out = [dict(c, **{axis: i}) for c in out
               for i in range(mesh.shape[axis])]
    return out


def destroy_model_parallel() -> None:
    """Tear down the grid (ref parallel_state.py:555): unbind the axis
    names and bind ``"dp"`` and ``"data"`` to the world again."""
    global _MESH, _VIRTUAL_PIPELINE_WORLD_SIZE, _VIRTUAL_PIPELINE_RANK
    global _PIPELINE_SPLIT_RANK
    if _MESH is not None:
        for axis in AXES:
            _backend.unbind(axis)
        if _backend.is_initialized():
            import torch.distributed as dist

            for name in (DATA_AXIS, "data"):
                _backend.bind(name, dist.group.WORLD)
    _MESH = None
    _VIRTUAL_PIPELINE_WORLD_SIZE = None
    _VIRTUAL_PIPELINE_RANK = None
    _PIPELINE_SPLIT_RANK = None
    _OVERRIDES.clear()


def get_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError(
            "model parallel mesh is not initialized "
            "(call initialize_model_parallel first)"
        )
    return _MESH


# ------------------------------------------------------------------ groups
# A "group" is the axis name (or tuple of names) collectives resolve.


def get_model_parallel_group() -> Tuple[str, str]:
    """tp+pp combined (ref parallel_state.py:273)."""
    get_mesh()
    return (PIPELINE_AXIS, TENSOR_AXIS)


def get_tensor_model_parallel_group() -> str:
    get_mesh()
    return TENSOR_AXIS


def get_pipeline_model_parallel_group() -> str:
    get_mesh()
    return PIPELINE_AXIS


def get_data_parallel_group() -> str:
    get_mesh()
    return DATA_AXIS


def get_context_parallel_group() -> str:
    get_mesh()
    return CONTEXT_AXIS


def get_embedding_group() -> str:
    """First and last pipeline stage share embedding grads (ref
    parallel_state.py:301): a masked sum over ``"pp"``
    (:func:`pipeline_parallel.p2p.embedding_allreduce`)."""
    get_mesh()
    return PIPELINE_AXIS


def get_position_embedding_group() -> str:
    get_mesh()
    return PIPELINE_AXIS


# ------------------------------------------------------------- world sizes


def _axis_size(axis: str) -> int:
    return get_mesh().shape[axis]


def get_tensor_model_parallel_world_size() -> int:
    ov = _OVERRIDES.get("tp_world")
    return ov if ov is not None else _axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    ov = _OVERRIDES.get("pp_world")
    return ov if ov is not None else _axis_size(PIPELINE_AXIS)


def get_data_parallel_world_size() -> int:
    ov = _OVERRIDES.get("dp_world")
    return ov if ov is not None else _axis_size(DATA_AXIS)


def get_context_parallel_world_size() -> int:
    ov = _OVERRIDES.get("cp_world")
    return ov if ov is not None else _axis_size(CONTEXT_AXIS)


def set_tensor_model_parallel_world_size(world_size) -> None:
    _OVERRIDES["tp_world"] = world_size


def set_pipeline_model_parallel_world_size(world_size) -> None:
    _OVERRIDES["pp_world"] = world_size


# ------------------------------------------------------------------- ranks


def _axis_rank(axis: str, override_key: str) -> int:
    ov = _OVERRIDES.get(override_key)
    if ov is not None:
        return ov
    if _MESH is None:
        return 0
    return _backend.get_rank(axis)


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS, "tp_rank")


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPELINE_AXIS, "pp_rank")


def get_data_parallel_rank() -> int:
    return _axis_rank(DATA_AXIS, "dp_rank")


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS, "cp_rank")


def set_tensor_model_parallel_rank(rank) -> None:
    _OVERRIDES["tp_rank"] = rank


def set_pipeline_model_parallel_rank(rank) -> None:
    _OVERRIDES["pp_rank"] = rank


def get_rank_info() -> Tuple:
    """(tp_rank, pp_rank, dp_rank) for debug logging (ref :250)."""
    return (
        get_tensor_model_parallel_rank(),
        get_pipeline_model_parallel_rank(),
        get_data_parallel_rank(),
    )


# -------------------------------------------------------- pipeline helpers


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """ref parallel_state.py:449."""
    if not ignore_virtual:
        if (
            _VIRTUAL_PIPELINE_WORLD_SIZE is not None
            and get_virtual_pipeline_model_parallel_rank() != 0
        ):
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    """ref parallel_state.py:460."""
    if not ignore_virtual:
        vws = _VIRTUAL_PIPELINE_WORLD_SIZE
        if vws is not None and get_virtual_pipeline_model_parallel_rank() != (
            vws - 1
        ):
            return False
    return (
        get_pipeline_model_parallel_rank()
        == get_pipeline_model_parallel_world_size() - 1
    )


def get_virtual_pipeline_model_parallel_rank():
    return _VIRTUAL_PIPELINE_RANK


def set_virtual_pipeline_model_parallel_rank(rank) -> None:
    global _VIRTUAL_PIPELINE_RANK
    _VIRTUAL_PIPELINE_RANK = rank


def get_virtual_pipeline_model_parallel_world_size():
    return _VIRTUAL_PIPELINE_WORLD_SIZE


def get_pipeline_model_parallel_split_rank():
    return _PIPELINE_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: int) -> None:
    global _PIPELINE_SPLIT_RANK
    _PIPELINE_SPLIT_RANK = rank


def is_pipeline_stage_before_split(rank=None) -> bool:
    """Encoder side of an encoder-decoder split (ref :338)."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    if _PIPELINE_SPLIT_RANK is None:
        return True
    return rank < _PIPELINE_SPLIT_RANK


def is_pipeline_stage_after_split(rank=None) -> bool:
    """Decoder side (ref :353)."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    if _PIPELINE_SPLIT_RANK is None:
        return True
    return rank >= _PIPELINE_SPLIT_RANK


def is_pipeline_stage_at_split() -> bool:
    """ref :368 — the stage feeding encoder output into the decoder."""
    rank = get_pipeline_model_parallel_rank()
    return is_pipeline_stage_before_split(rank) & is_pipeline_stage_after_split(
        rank + 1
    )


def is_rank_in_embedding_group(ignore_virtual: bool = False) -> bool:
    """First or last pp stage (ref :315)."""
    del ignore_virtual
    return is_pipeline_first_stage(ignore_virtual=True) | is_pipeline_last_stage(
        ignore_virtual=True
    )


def is_rank_in_position_embedding_group() -> bool:
    return is_pipeline_first_stage(ignore_virtual=True)


# ------------------------------------------------- global-rank conversions
# Global ranks of torch.distributed's world (ref :493-541).


def get_tensor_model_parallel_src_rank() -> int:
    """Global rank of tp-rank-0 in this rank's tp group (ref :493)."""
    world = get_tensor_model_parallel_world_size()
    # With tp innermost, the group leader is the floor to a multiple of tp.
    return (_flat_rank() // world) * world


def get_data_parallel_src_rank() -> int:
    """ref :501."""
    tp = get_tensor_model_parallel_world_size()
    cp = get_context_parallel_world_size()
    rank = _flat_rank()
    # dp varies over blocks of (cp*tp) within a pp stage.
    stage = rank % (get_data_parallel_world_size() * cp * tp)
    return (rank - stage) + stage % (cp * tp)


def get_pipeline_model_parallel_first_rank() -> int:
    return _flat_rank() % _stage_stride()


def get_pipeline_model_parallel_last_rank() -> int:
    return get_pipeline_model_parallel_first_rank() + _stage_stride() * (
        get_pipeline_model_parallel_world_size() - 1
    )


def get_pipeline_model_parallel_next_rank() -> int:
    stride = _stage_stride()
    world = get_pipeline_model_parallel_world_size()
    rank = _flat_rank()
    return rank % stride + stride * ((rank // stride + 1) % world)


def get_pipeline_model_parallel_prev_rank() -> int:
    stride = _stage_stride()
    world = get_pipeline_model_parallel_world_size()
    rank = _flat_rank()
    return rank % stride + stride * ((rank // stride - 1) % world)


def _stage_stride() -> int:
    return (
        get_data_parallel_world_size()
        * get_context_parallel_world_size()
        * get_tensor_model_parallel_world_size()
    )


def _flat_rank() -> int:
    ov = _OVERRIDES.get("flat_rank")
    if ov is not None:
        return ov
    pp = get_pipeline_model_parallel_rank()
    dp = get_data_parallel_rank()
    cp = get_context_parallel_rank()
    tp = get_tensor_model_parallel_rank()
    cpw = get_context_parallel_world_size()
    tpw = get_tensor_model_parallel_world_size()
    dpw = get_data_parallel_world_size()
    return ((pp * dpw + dp) * cpw + cp) * tpw + tp


def set_flat_rank(rank) -> None:
    _OVERRIDES["flat_rank"] = rank
