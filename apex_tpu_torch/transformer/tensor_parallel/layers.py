"""Tensor-parallel linear layers and embedding (port of
``apex_tpu/transformer/tensor_parallel/layers.py``).

The per-shard functions (:func:`column_parallel_linear`,
:func:`row_parallel_linear`, :func:`vocab_parallel_embedding`,
:func:`linear_with_grad_accumulation_and_async_allreduce`) take this
rank's shard of a weight and run the reference's collectives
(:mod:`.mappings`) over the group bound to ``axis_name`` (default
``"tp"``); with no group bound for it they are a product plus a bias and
a gather, as on one device. Weights keep the reference's ``(in, out)``
convention. The products go through ``ops.precision.matmul_amp`` under
the reference's site name ``"tp_linear"`` (``layers.py:44``): outside
the O4 fp8 context that is ``torch.matmul``, the reference computing
them outside any Pallas kernel too.

:class:`ColumnParallelLinear`, :class:`RowParallelLinear` and
:class:`VocabParallelEmbedding` are ``torch.nn.Module``s holding this
rank's shard. The reference's flax modules hold the logical full-size
weight and leave the sharding to XLA's partitioner; these draw the full
weight from a generator (the same on every rank) and keep their slice,
as Megatron's ``_initialize_affine_weight_cpu`` does, and mark it with
the tensor-parallel attributes. Like every entry point of the port they
are made on the GPU unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.ops.precision import matmul_amp, matmul_fp32acc
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility
from apex_tpu_torch.transformer.utils import divide

TP = parallel_state.TENSOR_AXIS

_MODEL_PARALLEL_ATTRIBUTE_DEFAULTS = {"tensor_model_parallel": False,
                                      "partition_dim": -1,
                                      "partition_stride": 1}


def set_tensor_model_parallel_attributes(tensor, is_parallel: bool,
                                         dim: int, stride: int) -> None:
    """Mark ``tensor`` as (not) split over tp along ``dim`` (ref
    layers.py:69, Megatron's attributes)."""
    tensor.tensor_model_parallel = is_parallel
    tensor.partition_dim = dim
    tensor.partition_stride = stride


def param_is_not_tensor_parallel_duplicate(param) -> bool:
    """True when the param is split over tp (ref layers.py:63: its
    partition names hold ``'tp'``)."""
    return bool(getattr(param, "tensor_model_parallel", False))


def set_defaults_if_not_set_tensor_model_parallel_attributes(tensor) -> None:
    """ref layers.py:79."""
    for attribute, value in _MODEL_PARALLEL_ATTRIBUTE_DEFAULTS.items():
        if not hasattr(tensor, attribute):
            setattr(tensor, attribute, value)


def copy_tensor_model_parallel_attributes(destination_tensor,
                                          source_tensor) -> None:
    """ref layers.py:88."""
    for attribute in _MODEL_PARALLEL_ATTRIBUTE_DEFAULTS:
        if hasattr(source_tensor, attribute):
            setattr(destination_tensor, attribute,
                    getattr(source_tensor, attribute))


def param_partition_specs(module: torch.nn.Module) -> dict:
    """``{name: spec}`` for a module's parameters: a spec is a tuple with
    one entry a dim, ``"tp"`` on the dim a parameter is split along and
    None elsewhere (the port's form of a ``PartitionSpec``)."""
    specs = {}
    for name, p in module.named_parameters():
        spec = [None] * p.dim()
        if param_is_not_tensor_parallel_duplicate(p):
            spec[p.partition_dim % p.dim()] = TP
        specs[name] = tuple(spec)
    return specs


# ------------------------------------------------------------------
# Per-shard functional forms.
# ------------------------------------------------------------------


class _MatmulFp32Wgrad(torch.autograd.Function):
    """``x @ weight`` in the activation's dtype with the weight gradient
    summed and returned in fp32 (``layers.py:250-279``, the TPU form of
    the reference's gradient-accumulation fusion): the stored weight is
    the fp32 master, the forward product runs in ``x``'s dtype, and the
    weight's cotangent comes back in the weight's dtype with fp32 sums."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return matmul_fp32acc(x, weight.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = matmul_fp32acc(g, weight.to(g.dtype).transpose(-1, -2))
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).float().T,
                          g.reshape(-1, g.shape[-1]).float())
        return dx.to(x.dtype), dw.to(weight.dtype)


def _matmul_fp32_wgrad(x, weight):
    return _MatmulFp32Wgrad.apply(x, weight)


def linear_with_grad_accumulation_and_async_allreduce(
    input,
    weight,
    bias=None,
    gradient_accumulation_fusion: bool = False,
    async_grad_allreduce: bool = True,
    sequence_parallel_enabled: bool = False,
    axis_name: Optional[str] = None,
    seq_dim: int = 0,
):
    """Local product whose input gradient is all-reduced over tp (ref
    layers.py:308): the input goes through ``copy_to`` (or, under
    sequence parallelism, the all-gather of the sequence), then ``input
    @ weight`` (``weight`` is this rank's ``(in, out_local)`` shard).
    ``async_grad_allreduce`` is accepted and ignored, as in the
    reference. ``gradient_accumulation_fusion`` takes
    :func:`_matmul_fp32_wgrad`."""
    del async_grad_allreduce
    axis = axis_name if axis_name is not None else TP
    if sequence_parallel_enabled:
        x = mappings.gather_from_sequence_parallel_region(input, axis,
                                                          seq_dim=seq_dim)
    else:
        x = mappings.copy_to_tensor_model_parallel_region(input, axis)
    if gradient_accumulation_fusion:
        y = _matmul_fp32_wgrad(x, weight)
    else:
        y = matmul_amp(x, weight, name="tp_linear")
    if bias is not None:
        y = y + bias
    return y


def column_parallel_linear(
    x,
    kernel,
    bias=None,
    gather_output: bool = True,
    sequence_parallel_enabled: bool = False,
    axis_name: Optional[str] = None,
    seq_dim: int = 0,
):
    """Per-shard column-parallel linear (ref layers.py:321): ``kernel``
    is ``(in, out/tp)``, ``bias`` ``(out/tp,)``; ``gather_output``
    all-gathers the output's last dim."""
    axis = axis_name if axis_name is not None else TP
    y = linear_with_grad_accumulation_and_async_allreduce(
        x, kernel, bias, sequence_parallel_enabled=sequence_parallel_enabled,
        axis_name=axis, seq_dim=seq_dim,
    )
    if gather_output:
        y = mappings.gather_from_tensor_model_parallel_region(y, axis)
    return y


def row_parallel_linear(
    x,
    kernel,
    bias=None,
    input_is_parallel: bool = True,
    sequence_parallel_enabled: bool = False,
    axis_name: Optional[str] = None,
    seq_dim: int = 0,
):
    """Per-shard row-parallel linear (ref layers.py:341): ``kernel`` is
    ``(in/tp, out)``; the partial products are all-reduced (or, under
    sequence parallelism, reduce-scattered over the sequence), then the
    (replicated) bias is added."""
    axis = axis_name if axis_name is not None else TP
    if not input_is_parallel:
        x = mappings.scatter_to_tensor_model_parallel_region(x, axis)
    y = matmul_amp(x, kernel, name="tp_linear")
    if sequence_parallel_enabled:
        y = mappings.reduce_scatter_to_sequence_parallel_region(
            y, axis, seq_dim=seq_dim)
    else:
        y = mappings.reduce_from_tensor_model_parallel_region(y, axis)
    if bias is not None:
        y = y + bias
    return y


def vocab_parallel_embedding(ids, table, axis_name: Optional[str] = None):
    """Per-shard vocab-parallel lookup (ref layers.py:366-385): ``table``
    is this rank's ``(vocab/tp, hidden)`` rows. Ids outside this rank's
    range are masked, looked up as row 0 and zeroed, and the ranks'
    results are summed (the gradient of the sum is the identity)."""
    axis = axis_name if axis_name is not None else TP
    if not _axis_bound(axis):
        return F.embedding(ids, table)
    start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
        table.shape[0], _backend.get_rank(axis),
        _backend.get_world_size(axis))
    local = ids - start
    in_range = (local >= 0) & (local < table.shape[0])
    safe = torch.where(in_range, local, torch.zeros_like(local))
    out = F.embedding(safe, table)
    out = torch.where(in_range[..., None], out, torch.zeros_like(out))
    return mappings.reduce_from_tensor_model_parallel_region(out, axis)


# ------------------------------------------------------------------
# Module forms.
# ------------------------------------------------------------------


def _tp_size_rank(axis: str) -> Tuple[int, int]:
    if not _axis_bound(axis):
        return 1, 0
    return _backend.get_world_size(axis), _backend.get_rank(axis)


def _xavier_normal(shape, generator, dtype, device):
    """The reference's default init (``nn.initializers.xavier_normal``)
    of the full ``(in, out)`` weight: N(0, 2 / (in + out))."""
    std = (2.0 / (shape[0] + shape[1])) ** 0.5
    g_dev = generator.device if generator is not None else device
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=g_dev)
    return (w * std).to(dtype=dtype, device=device)


class _ShardedModule(torch.nn.Module):
    """Shared bookkeeping: the axis, its size and this rank's index."""

    def _setup(self, axis_name):
        self.axis_name = axis_name if axis_name is not None else TP
        self.world_size, self.rank = _tp_size_rank(self.axis_name)

    def _shard(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        n = divide(full.shape[dim], self.world_size)
        return full.narrow(dim, self.rank * n, n).clone()

    def _param(self, full, dim, parallel: bool):
        data = self._shard(full, dim) if parallel else full.clone()
        p = torch.nn.Parameter(data)
        set_tensor_model_parallel_attributes(p, parallel, dim, 1)
        return p


class ColumnParallelLinear(_ShardedModule):
    """Y = X·A with A ``(in, out)`` split column-wise over tp (ref
    layers.py:377). ``forward`` returns ``(output, output_bias)``:
    ``output_bias`` is the unapplied bias when ``skip_bias_add``, else
    None. ``keep_master_weight_for_test`` keeps the full weight as
    ``master_weight``."""

    def __init__(self, input_size: int, output_size: int,
                 bias: bool = True, gather_output: bool = True,
                 init_method=None, stride: int = 1,
                 keep_master_weight_for_test: bool = False,
                 skip_bias_add: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 sequence_parallel_enabled: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        del stride  # accepted for parity
        device = _device.resolve(device)
        self._setup(axis_name)
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        full = (init_method or _xavier_normal)(
            (input_size, output_size), generator, params_dtype, device)
        self.weight = self._param(full, 1, True)
        if keep_master_weight_for_test:
            self.master_weight = full
        self.bias = (self._param(torch.zeros(output_size, dtype=params_dtype,
                                             device=device), 0, True)
                     if bias else None)

    def forward(self, x):
        bias = None if self.skip_bias_add else self.bias
        y = linear_with_grad_accumulation_and_async_allreduce(
            x, self.weight, bias,
            gradient_accumulation_fusion=self.gradient_accumulation_fusion,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            axis_name=self.axis_name)
        if self.gather_output:
            y = mappings.gather_from_tensor_model_parallel_region(
                y, self.axis_name)
        return y, (self.bias if self.skip_bias_add else None)


class RowParallelLinear(_ShardedModule):
    """Y = X·A with A ``(in, out)`` split row-wise over tp; the output is
    all-reduced, or reduce-scattered over the sequence under sequence
    parallelism (ref layers.py:541). The bias is replicated and added
    after the reduction."""

    def __init__(self, input_size: int, output_size: int,
                 bias: bool = True, input_is_parallel: bool = False,
                 init_method=None, stride: int = 1,
                 keep_master_weight_for_test: bool = False,
                 skip_bias_add: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 sequence_parallel_enabled: bool = False,
                 axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        del stride
        device = _device.resolve(device)
        self._setup(axis_name)
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        full = (init_method or _xavier_normal)(
            (input_size, output_size), generator, params_dtype, device)
        self.weight = self._param(full, 0, True)
        if keep_master_weight_for_test:
            self.master_weight = full
        self.bias = (self._param(torch.zeros(output_size, dtype=params_dtype,
                                             device=device), 0, False)
                     if bias else None)

    def forward(self, x):
        y = row_parallel_linear(
            x, self.weight, None, input_is_parallel=self.input_is_parallel,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            axis_name=self.axis_name)
        if self.bias is not None and not self.skip_bias_add:
            y = y + self.bias
        return y, (self.bias if self.skip_bias_add else None)


class VocabParallelEmbedding(_ShardedModule):
    """Embedding table split over the vocab dim (ref layers.py:154). The
    default init is N(0, 1), the reference's."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method=None, params_dtype: torch.dtype = torch.float32,
                 axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = _device.resolve(device)
        self._setup(axis_name)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        if init_method is None:
            g_dev = generator.device if generator is not None else device
            full = torch.randn((num_embeddings, embedding_dim),
                               generator=generator, dtype=torch.float32,
                               device=g_dev).to(dtype=params_dtype,
                                                device=device)
        else:
            full = init_method((num_embeddings, embedding_dim), generator,
                               params_dtype, device)
        self.weight = self._param(full, 0, True)
        (self.vocab_start_index,
         self.vocab_end_index) = VocabUtility.vocab_range_from_global_vocab_size(
            num_embeddings, self.rank, self.world_size)

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight, self.axis_name)
