"""Functional FusedAdam (port of ``apex_tpu/optimizers/fused_adam.py``).

``fused_adam(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)``, the optax-style
transform of the JAX package over nested dicts of tensors. With
``flat=True`` every parameter of one dtype is packed into one slab and
updated by one launch of the flat Adam kernel
(``ops/fused_adam_kernel.py``) when the tensors are on the GPU, or by its
plain version when they are on the CPU, as
``kernel_config.use_kernel("flat_adam", ...)`` decides (``force("off")``
takes the plain version on the card too; the JAX
``use_kernel`` argument is not carried over). With
``flat=False`` (the default, as in the JAX package, which runs it outside
any Pallas kernel too) :func:`_math.adam_step` runs leaf by leaf.

The step counter ``count`` is an int32 0-dim tensor on the CPU: it
mirrors the JAX state's int32 scalar, and the fp32 learning rate and
bias-correction scalars are computed from it on the host, so a step
never waits for the device.

:class:`FusedAdam` is the stateful class (``fused_adam.py:162``) over
this transform: ``FusedAdam(params, lr=..., flat=True).step(grads)``
updates the params in place, the flat Adam kernel once a step for each
dtype of the params.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch.observability import get_registry
from apex_tpu_torch.observability.profiling.spans import span
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops import kernel_config
from apex_tpu_torch.ops.fused_adam_kernel import adam_flat
from apex_tpu_torch.optimizers import _math
from apex_tpu_torch.optimizers._base import FusedOptimizer

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], Any]]


class FusedAdamState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    mu: Any  # fp32: a tree like params, or {dtype name: slab} when flat
    nu: Any


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _lr_at(lr: ScalarOrSchedule, count):
    return lr(count) if callable(lr) else lr


def fused_adam(lr: ScalarOrSchedule = 1e-3, bias_correction: bool = True,
               betas=(0.9, 0.999), eps: float = 1e-8,
               adam_w_mode: bool = True, weight_decay: float = 0.0,
               flat: bool = False) -> GradientTransformation:
    """Functional FusedAdam; arguments mirror the JAX package's
    ``fused_adam`` (``fused_adam.py:41``) less ``use_kernel``."""
    b1, b2 = betas

    def init(params):
        if flat:
            _, _, specs = _flat.tree_meta(params)
            device = _device.of(params)
            mu = {k: torch.zeros((spec.total,), dtype=torch.float32,
                                 device=device)
                  for k, (_, spec) in specs.items()}
            nu = {k: torch.zeros_like(z) for k, z in mu.items()}
        else:
            mu = _tree.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            nu = _tree.map_leaves(torch.zeros_like, mu)
        return FusedAdamState(count=torch.zeros((), dtype=torch.int32),
                              mu=mu, nu=nu)

    def update(grads, state, params=None):
        """-> (updates, new state). Updates are in each param's dtype.
        In flat mode the state's m/v slabs are updated in place and
        carried into the new state; in tree mode new tensors are made."""
        if params is None:
            raise ValueError("fused_adam requires params (for weight "
                             "decay / bias)")
        count = state.count + 1
        step = count.to(torch.float32)
        # optax convention: the schedule sees the pre-increment count
        lr_t = _lr_at(lr, state.count)
        kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  adam_w_mode=adam_w_mode, bias_correction=bias_correction)
        g_leaves = _tree.leaves(grads)
        p_leaves = _tree.leaves(params)
        reg = get_registry()
        if flat:
            # the reference's dispatch record: the counter ticks once an
            # update, and the span names the path ("cuda": the flat Adam
            # kernel on the card; "plain": its PyTorch version) in a
            # profiler trace, as kernel_config decides for adam_flat
            path = ("cuda" if p_leaves and kernel_config.dispatch(
                "flat_adam", p_leaves[0], count=False) == "kernel"
                else "plain")
            reg.counter("optimizer/fused_adam/dispatch",
                        path=f"flat_{path}").inc()
            with span(f"fused_adam/flat/{path}"):
                # grouped by *param* dtype; grads of any dtype pack as fp32
                meta = _flat.tree_meta(params)
                deltas, mu, nu = {}, {}, {}
                for k, (idxs, spec) in meta[2].items():
                    gbuf, _ = _flat.flatten_tensors(
                        [g_leaves[i] for i in idxs], spec,
                        dtype=torch.float32)
                    pbuf, _ = _flat.flatten_tensors(
                        [p_leaves[i] for i in idxs], spec)
                    # delta comes back in the slab's (the params') dtype
                    deltas[k], mu[k], nu[k] = adam_flat(
                        gbuf, pbuf, state.mu[k], state.nu[k], lr_t, step,
                        **kw)
                    del gbuf, pbuf
                updates = _flat.unflatten_tree(deltas, meta)
        else:
            reg.counter("optimizer/fused_adam/dispatch", path="tree").inc()
            with span("fused_adam/tree"):
                m_leaves = _tree.leaves(state.mu)
                v_leaves = _tree.leaves(state.nu)
                # each leaf's fp32 delta is cast to the param's dtype as
                # it is made, so no more than one leaf's fp32 delta is
                # alive
                deltas, mus, nus = [], [], []
                for g, p, m, v in zip(g_leaves, p_leaves, m_leaves,
                                      v_leaves):
                    delta, m, v = _math.adam_step(g, p, m, v, lr=lr_t,
                                                  step=step, **kw)
                    deltas.append(delta.to(p.dtype))
                    mus.append(m)
                    nus.append(v)
                    del delta
                paths = _tree.paths(params)
                updates = _tree.unflatten(paths, deltas)
                mu = _tree.unflatten(paths, mus)
                nu = _tree.unflatten(paths, nus)
        return updates, FusedAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


class FusedAdam(FusedOptimizer):
    """Stateful Apex-style API (``fused_adam.py:162``):
    ``opt = FusedAdam(params, lr=1e-3); opt.step(grads)``."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 flat=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        del set_grad_none  # no .grad attributes: kept for API parity
        kw = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                  eps=eps, adam_w_mode=adam_w_mode,
                  weight_decay=weight_decay, flat=flat)
        super().__init__(params, fused_adam(**kw), dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay),
            tx_factory=lambda **ov: fused_adam(**{**kw, **ov}))


def _state_classes() -> dict:
    """The port's optimizer states by class name (imported here: the
    modules that define them import this one)."""
    from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagradState
    from apex_tpu_torch.optimizers.fused_lamb import FusedLAMBState
    from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
        FusedMPLambState,
    )
    from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGradState
    from apex_tpu_torch.optimizers.fused_sgd import FusedSGDState
    from apex_tpu_torch.parallel.larc import LARCState

    return {cls.__name__: cls for cls in (
        FusedAdamState, FusedLAMBState, FusedSGDState, FusedAdagradState,
        FusedNovoGradState, FusedMPLambState, LARCState)}


def _state_from_numpy(state, device: torch.device, classes: dict):
    fields = {}
    for name, value in zip(state._fields, state):
        if name == "count":
            fields[name] = torch.tensor(int(value), dtype=torch.int32)
        elif hasattr(value, "_fields"):
            fields[name] = _state_from_numpy(value, device, classes)
        else:
            fields[name] = _device.from_numpy(value, device)
    cls = classes.get(type(state).__name__)
    if cls is None:
        raise TypeError(f"no port of optimizer state "
                        f"{type(state).__name__}: expected one of "
                        f"{sorted(classes)}")
    return cls(**fields)


def opt_state_from_numpy(state, device: _device.DeviceLike = None):
    """The JAX package's optimizer state with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) as the port's, by its
    class name: ``FusedAdamState`` in either mode, ``FusedLAMBState``,
    ``FusedSGDState``, ``FusedAdagradState(count, sum)``,
    ``FusedNovoGradState(count, mu, v_norm)``, ``FusedMPLambState(master,
    inner)`` and ``LARCState(inner, count)``, nested states converted in
    turn. Counts become int32 tensors on the CPU, every other leaf lands
    on ``device``: the optimizer half of carrying a run across."""
    return _state_from_numpy(state, _device.resolve(device),
                             _state_classes())
