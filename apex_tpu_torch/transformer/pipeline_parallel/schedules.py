"""Pipeline-parallel schedules (port of
``apex_tpu/transformer/pipeline_parallel/schedules.py``).

The reference's schedules are collective: every stage runs the same
program, a scan over time steps in which each stage computes its
microbatch and shifts its activations downstream, and the backward
pipeline is what autodiff makes of the scan (the transpose of a +1 shift
is a -1 shift). The port keeps that form. Each stage is a process; a
tick computes this stage's microbatch and shifts the result with
:func:`p2p._shift`, an autograd ``Function`` whose backward is the -1
shift, so ``loss.backward()`` on every rank runs the reverse pipeline.

Every rank issues the same shifts in the same order, forward and
backward, bubble ticks included:

- a tick that holds no valid microbatch for this stage (a bubble) skips
  the stage's compute and shifts zeros, which the receiver ignores as
  the reference's ``where`` does; its values and gradients are those of
  the reference, whose bubble compute never reaches the loss;
- every shift takes an ``anchor`` that requires grad, so its backward
  node exists on every rank; a bubble's zeros are tied to the stage's
  params (:class:`_Bubble`), so that node leads to the params whose
  gradients are asked for (``torch.autograd.grad`` runs only such
  nodes); and the shifted tensors no tick consumes are tied to the
  outputs by :class:`_Attach`, whose backward hands them zeros: each
  rank's backward then runs every shift node, in reverse tick order;
- the loss is computed on the last stage only (the others' losses are
  masked to 0 in the reference, so their gradients are 0 either way)
  and summed over the stages with an identity backward.

Conventions (the reference's):
- ``stage_fn(stage_params, x) -> y`` applies THIS stage's slice of the
  model; activation shapes match across stages;
- microbatched tensors carry a leading microbatch dim ``[M, mb, ...]``;
  inputs are read by stage 0, outputs are meaningful on the last stage.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.amp.frontend import map_tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.pipeline_parallel import p2p
from apex_tpu_torch.transformer.tensor_parallel import mappings


class ExperimentalWarning(Warning):
    """ref schedules/__init__.py:18."""


class InterleavedFallbackWarning(UserWarning):
    """The interleaved schedule falls back to chained GPipe (a different
    bubble cost) when M % P != 0."""


def _axis(axis_name: Optional[str]) -> str:
    return axis_name if axis_name is not None else parallel_state.PIPELINE_AXIS


def _stage_coords(axis: str):
    """(number of stages, this rank's stage) along ``axis``; one stage
    when no group is bound to it."""
    if not _backend.is_bound(axis):
        return 1, 0
    return _backend.get_world_size(axis), _backend.get_rank(axis)


# ------------------------------------------------------------ no pipelining


def _live(params):
    return _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)


def forward_backward_no_pipelining(
    loss_fn: Callable,
    params,
    microbatches,
    forward_only: bool = False,
    grad_scale=None,
):
    """Microbatched gradient accumulation without pipelining
    (ref fwd_bwd_no_pipelining.py:31).

    ``loss_fn(params, microbatch) -> scalar``; ``microbatches`` is a
    tensor or a tuple/dict of them with a leading microbatch dim M.
    Returns ``(mean_loss, grads)``: grads (a tree like ``params``) are the
    sum over microbatches times ``1 / M`` (``grad_scale / M`` when given),
    None when ``forward_only``.
    """
    leaves = _tree.flatten(microbatches)[0]
    m_count = leaves[0].shape[0]

    def kth(k):
        return map_tree(lambda a: a[k], microbatches)

    if forward_only:
        with torch.no_grad():
            total = sum(loss_fn(params, kth(k)) for k in range(m_count))
        return total / m_count, None
    paths = _tree.paths(params)
    loss_sum, grad_sum = 0.0, None
    with span("pp/grad_accum"):
        for k in range(m_count):
            live = _live(params)
            loss = loss_fn(live, kth(k))
            grads = torch.autograd.grad(loss, _tree.leaves(live))
            grad_sum = (list(grads) if grad_sum is None
                        else [a + g for a, g in zip(grad_sum, grads)])
            loss_sum = loss_sum + loss.detach()
    scale = 1.0 / m_count if grad_scale is None else grad_scale / m_count
    grads = _tree.unflatten(paths, [g * scale for g in grad_sum])
    return loss_sum / m_count, grads


# ------------------------------------------------------ collective pipeline


def _maybe_remat(stage_fn, remat):
    """remat: False = none; True = full recompute; "dots" = keep the
    products' outputs (the contract of ``models.llama.run_layers``)."""
    if not remat:
        return stage_fn
    from torch.utils.checkpoint import checkpoint

    from apex_tpu_torch.models._common import _dots_contexts

    if remat == "dots":
        return lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False,
                                       context_fn=_dots_contexts)
    return lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False)


class _Attach(torch.autograd.Function):
    """``out`` as it is; the backward passes ``out``'s gradient through
    and hands every tensor of ``dangling`` a zero gradient, so that the
    nodes that made them run in the backward."""

    @staticmethod
    def forward(ctx, out, *dangling):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in dangling]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.shapes])


def _attach(out, dangling):
    dangling = [d for d in dangling if d.requires_grad]
    return _Attach.apply(out, *dangling) if dangling else out


class _ZeroFrom(torch.autograd.Function):
    """A 0-dim zero whose gradient to ``x`` is zeros: the loss of a
    stage that holds no loss, still tied to its outputs."""

    @staticmethod
    def forward(ctx, x):
        ctx.meta = (x.shape, x.dtype, x.device)
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.meta
        return torch.zeros(shape, dtype=dtype, device=device)


class _Bubble(torch.autograd.Function):
    """Zeros like ``like`` that depend on ``params`` (no gradient flows
    back): a bubble tick's output, tied to the stage's params so that
    the shift that sends it runs in every backward that asks for
    them."""

    @staticmethod
    def forward(ctx, like, *params):
        ctx.n = len(params)
        return torch.zeros_like(like)

    @staticmethod
    def backward(ctx, g):
        return (None,) * (1 + ctx.n)


def _bubble(like: torch.Tensor, stage_params) -> torch.Tensor:
    params = [p for p in _tree.leaves(stage_params)
              if isinstance(p, torch.Tensor) and p.requires_grad]
    if not params or not torch.is_grad_enabled():
        return torch.zeros_like(like)
    return _Bubble.apply(like.detach(), *params)


def _anchor(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device,
                       requires_grad=True)


def pipelined_forward(
    stage_fn: Callable,
    stage_params,
    inputs,
    axis_name: Optional[str] = None,
    remat=True,
):
    """GPipe/1F1B collective forward (ref schedules.py:115-163): M + P - 1
    ticks with a +1 shift each.

    ``inputs``: [M, mb, ...], read by stage 0 (other stages pass a tensor
    of the same shape, e.g. zeros). Returns [M, mb, ...] activations,
    meaningful on the LAST stage (zeros elsewhere), differentiable.
    """
    axis = _axis(axis_name)
    n_stage, rank = _stage_coords(axis)
    m_count = inputs.shape[0]
    steps = m_count + n_stage - 1
    body_fn = _maybe_remat(stage_fn, remat)
    anchor = _anchor(inputs)
    incoming = None
    outputs: List[Optional[torch.Tensor]] = [None] * m_count
    # only stage 0 reads the inputs; elsewhere they are tied to the
    # outputs, so a shift that made them (a chained pass) runs backward
    dangling = [] if rank == 0 else [inputs]
    with span("pp/forward"):
        for t in range(steps):
            u = t - rank  # the microbatch this stage holds at tick t
            if 0 <= u < m_count:
                x = inputs[u] if rank == 0 else incoming
                if rank == 0 and incoming is not None:
                    dangling.append(incoming)
                with span("pp/stage_compute"):
                    y = body_fn(stage_params, x)
            else:  # a bubble: nothing to compute, zeros go downstream
                if incoming is not None:
                    dangling.append(incoming)
                y = _bubble(inputs[0], stage_params)
            if t >= n_stage - 1 and rank == n_stage - 1:
                outputs[t - (n_stage - 1)] = y
            with span("pp/send_recv"):
                incoming = p2p._shift(y, +1, axis, anchor=anchor)
    dangling.append(incoming)
    outs = torch.stack([o if o is not None else torch.zeros_like(inputs[0])
                        for o in outputs])
    return _attach(outs, dangling)


def _last_stage_mean_loss(loss_fn, outputs, targets, axis):
    """The mean over microbatches of ``loss_fn`` on the last stage, summed
    over the stages with an identity backward (ref schedules.py:166); the
    other stages compute no loss (theirs is masked to 0)."""
    n_stage, rank = _stage_coords(axis)
    if rank == n_stage - 1:
        losses = torch.stack([loss_fn(outputs[i], targets[i])
                              for i in range(outputs.shape[0])])
        local = torch.mean(losses)
    else:
        local = _ZeroFrom.apply(outputs)
    return mappings.reduce_from_tensor_model_parallel_region(local, axis)


def forward_backward_pipelining_without_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    inputs,
    targets,
    forward_only: bool = False,
    axis_name: Optional[str] = None,
    remat=True,
):
    """1F1B equivalent (ref fwd_bwd_pipelining_without_interleaving.py:156):
    the forward is :func:`pipelined_forward`, the backward pipeline is
    autograd's.

    ``loss_fn(one_output_mb, one_target_mb) -> scalar``. Returns
    ``(mean_loss, stage_grads)``: every stage gets the loss and the
    grads of ITS OWN ``stage_params``.
    """
    axis = _axis(axis_name)
    if forward_only:
        with torch.no_grad():
            outs = pipelined_forward(stage_fn, stage_params, inputs, axis,
                                     remat=False)
            with span("pp/loss"):
                loss = _last_stage_mean_loss(loss_fn, outs, targets, axis)
            return loss, None
    with span("pp/forward_backward"):
        live = _live(stage_params)
        outs = pipelined_forward(stage_fn, live, inputs, axis, remat)
        with span("pp/loss"):
            loss = _last_stage_mean_loss(loss_fn, outs, targets, axis)
        grads = torch.autograd.grad(loss, _tree.leaves(live),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(_tree.leaves(live), grads)]
    return loss.detach(), _tree.unflatten(_tree.paths(stage_params), grads)


def interleaved_num_steps(m_count: int, p: int, v: int) -> int:
    """Ticks of the interleaved schedule, ``V*M + P - 1`` (vs
    ``V*(M + P - 1)`` for V chained GPipe passes): the bubble shrinks by
    ``(V-1)(P-1)`` ticks."""
    return v * m_count + p - 1


def _chunk(stage_params_chunks, v: int):
    return _tree.map_leaves(lambda a: a[v], stage_params_chunks)


def _num_chunks(stage_params_chunks) -> int:
    return _tree.leaves(stage_params_chunks)[0].shape[0]


def pipelined_forward_chained(
    stage_fn: Callable,
    stage_params_chunks,
    inputs,
    axis_name: Optional[str] = None,
    remat=True,
):
    """V chained GPipe passes with a cyclic last -> first shift between
    chunks, the fallback when M is not a multiple of P (ref
    schedules.py:200)."""
    axis = _axis(axis_name)
    v_size = _num_chunks(stage_params_chunks)
    outs = inputs
    for v in range(v_size):
        outs = pipelined_forward(stage_fn, _chunk(stage_params_chunks, v),
                                 outs, axis, remat)
        if v < v_size - 1:
            # the last stage hands the chunk's output back to stage 0
            outs = p2p._shift_cyclic(outs, +1, axis, anchor=_anchor(outs))
    return outs


def pipelined_forward_interleaved(
    stage_fn: Callable,
    stage_params_chunks,
    inputs,
    axis_name: Optional[str] = None,
    remat=True,
    strict: bool = False,
):
    """Interleaved virtual-pipeline forward (ref schedules.py:226;
    fwd_bwd_pipelining_with_interleaving.py:26).

    ``stage_params_chunks`` carries a leading virtual-chunk dim V: rank r
    owns virtual stages (r, r+P, ..., r+(V-1)P). ``V*M + P - 1`` ticks;
    rank r at tick t runs unit ``u = t - r``: chunk ``(u // P) % V`` of
    microbatch ``(u // (V*P)) * P + u % P``, so every dependency is "my
    ring neighbour made it one tick ago" and one cyclic shift a tick
    carries them all. Needs ``M % P == 0``; other sizes fall back to
    :func:`pipelined_forward_chained` with an
    :class:`InterleavedFallbackWarning`, or raise when ``strict``.
    """
    axis = _axis(axis_name)
    p, rank = _stage_coords(axis)
    m_count = inputs.shape[0]
    v = _num_chunks(stage_params_chunks)
    if m_count % p:
        msg = (
            f"interleaved schedule needs whole microbatch groups: "
            f"num_microbatches={m_count} is not a multiple of "
            f"pipeline_size={p}; falling back to chained GPipe "
            f"({v}·({m_count}+{p}−1) = {v * (m_count + p - 1)} ticks "
            f"instead of {interleaved_num_steps(m_count, p, v)} — a "
            f"different bubble cost model). Pad the microbatch count or "
            f"pass strict=True to fail instead.")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, InterleavedFallbackWarning, stacklevel=2)
        return pipelined_forward_chained(
            stage_fn, stage_params_chunks, inputs, axis, remat)
    units = v * m_count
    steps = interleaved_num_steps(m_count, p, v)
    body_fn = _maybe_remat(stage_fn, remat)
    anchor = _anchor(inputs)
    incoming = None
    outputs: List[Optional[torch.Tensor]] = [None] * m_count
    # only stage 0 reads the inputs; elsewhere they are tied to the
    # outputs, so a shift that made them (a chained pass) runs backward
    dangling = [] if rank == 0 else [inputs]
    with span("pp/forward_interleaved"):
        for t in range(steps):
            u = t - rank
            if 0 <= u < units:
                c = (u // p) % v
                m = (u // (v * p)) * p + u % p
                first = rank == 0 and c == 0  # virtual stage 0 reads inputs
                x = inputs[m] if first else incoming
                if first and incoming is not None:
                    dangling.append(incoming)
                with span("pp/stage_compute"):
                    y = body_fn(_chunk(stage_params_chunks, c), x)
                if rank == p - 1 and c == v - 1:
                    outputs[m] = y
            else:
                if incoming is not None:
                    dangling.append(incoming)
                y = _bubble(inputs[0], stage_params_chunks)
            with span("pp/send_recv"):
                incoming = p2p._shift_cyclic(y, +1, axis, anchor=anchor)
    dangling.append(incoming)
    outs = torch.stack([o if o is not None else torch.zeros_like(inputs[0])
                        for o in outputs])
    return _attach(outs, dangling)


def _forward_backward_pipelining_with_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params_chunks,
    inputs,
    targets,
    forward_only: bool = False,
    axis_name: Optional[str] = None,
    remat=True,
    strict: bool = False,
):
    """Interleaved-schedule entry (ref
    fwd_bwd_pipelining_with_interleaving.py:26): the true interleaved
    order when ``M % P == 0``, else chained GPipe with an
    :class:`InterleavedFallbackWarning`, or a raise when ``strict``."""
    axis = _axis(axis_name)
    if forward_only:
        with torch.no_grad():
            outs = pipelined_forward_interleaved(
                stage_fn, stage_params_chunks, inputs, axis, False, strict)
            with span("pp/loss"):
                loss = _last_stage_mean_loss(loss_fn, outs, targets, axis)
            return loss, None
    with span("pp/forward_backward"):
        live = _live(stage_params_chunks)
        outs = pipelined_forward_interleaved(stage_fn, live, inputs, axis,
                                             remat, strict=strict)
        with span("pp/loss"):
            loss = _last_stage_mean_loss(loss_fn, outs, targets, axis)
        grads = torch.autograd.grad(loss, _tree.leaves(live),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(_tree.leaves(live), grads)]
    return loss.detach(), _tree.unflatten(_tree.paths(stage_params_chunks),
                                          grads)


forward_backward_pipelining_with_interleaving = (
    _forward_backward_pipelining_with_interleaving
)


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_size: Optional[int] = None,
):
    """Pick the schedule (ref schedules/__init__.py:22)."""
    if pipeline_model_parallel_size is None:
        pipeline_model_parallel_size = (
            parallel_state.get_pipeline_model_parallel_world_size()
        )
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            warnings.warn(
                "interleaved collective schedule (chained fallback when "
                "num_microbatches % pp != 0)",
                ExperimentalWarning,
            )
            return _forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


# ---------------------------------------------------------------- build_model


def build_model(
    model_provider_func: Callable,
    wrap_with_ddp: bool = True,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    model_type=None,
    **kwargs,
) -> List:
    """One model (chunk) per virtual pipeline rank (ref
    schedules/common.py:29). ``model_provider_func(pre_process,
    post_process, **kwargs)`` returns a model; the flags tell it whether
    this chunk holds the embedding / the head. ``wrap_with_ddp`` wraps
    each in :class:`apex_tpu_torch.parallel.DistributedDataParallel`."""
    del model_type
    pp_world = parallel_state.get_pipeline_model_parallel_world_size()
    pp_rank = parallel_state.get_pipeline_model_parallel_rank()
    v = virtual_pipeline_model_parallel_size
    models = []
    n_chunks = v if v is not None else 1
    for chunk in range(n_chunks):
        stage_id = (
            pp_rank + chunk * pp_world if v is not None else pp_rank
        )
        total = pp_world * n_chunks
        model = model_provider_func(
            pre_process=(stage_id == 0),
            post_process=(stage_id == total - 1),
            **kwargs,
        )
        if wrap_with_ddp:
            from apex_tpu_torch.parallel import DistributedDataParallel

            model = DistributedDataParallel(model)
        models.append(model)
    return models


def get_params_for_weight_decay_optimization(params) -> dict:
    """Weight-decay mask tree: True for rank >= 2 kernels, False for
    biases and norm scales (ref schedules/common.py:161)."""
    return _tree.map_leaves(lambda p: p.dim() >= 2, params)
