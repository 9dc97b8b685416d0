"""Functional FusedAdam (port of ``apex_tpu/optimizers/fused_adam.py``).

``fused_adam(...)`` returns an object with ``init(params)`` and
``update(grads, state, params) -> (updates, state)``, the optax-style
transform of the JAX package over nested dicts of tensors. With
``flat=True`` every parameter of one dtype is packed into one slab and
updated by one launch of the flat Adam kernel
(``ops/fused_adam_kernel.py``) when the tensors are on the GPU, or by its
plain version when they are on the CPU: the device decides, and there is
no switch (the JAX ``use_kernel`` knob is not carried over). With
``flat=False`` (the default, as in the JAX package, which runs it outside
any Pallas kernel too) :func:`_math.adam_step` runs leaf by leaf.

The step counter ``count`` is an int32 0-dim tensor on the CPU: it
mirrors the JAX state's int32 scalar, and the fp32 learning rate and
bias-correction scalars are computed from it on the host, so a step
never waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops.fused_adam_kernel import adam_flat
from apex_tpu_torch.optimizers import _math

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
        if flat:
            # grouped by *param* dtype; grads of any dtype pack as fp32
            meta = _flat.tree_meta(params)
            deltas, mu, nu = {}, {}, {}
            for k, (idxs, spec) in meta[2].items():
                gbuf, _ = _flat.flatten_tensors(
                    [g_leaves[i] for i in idxs], spec, dtype=torch.float32)
                pbuf, _ = _flat.flatten_tensors(
                    [p_leaves[i] for i in idxs], spec)
                # delta comes back in the slab's (the params') dtype
                deltas[k], mu[k], nu[k] = adam_flat(
                    gbuf, pbuf, state.mu[k], state.nu[k], lr_t, step, **kw)
                del gbuf, pbuf
            updates = _flat.unflatten_tree(deltas, meta)
        else:
            m_leaves = _tree.leaves(state.mu)
            v_leaves = _tree.leaves(state.nu)
            results = [_math.adam_step(g, p, m, v, lr=lr_t, step=step, **kw)
                       for g, p, m, v in zip(g_leaves, p_leaves, m_leaves,
                                             v_leaves)]
            paths = _tree.paths(params)
            updates = _tree.unflatten(
                paths, [r[0].to(p.dtype) for r, p in zip(results,
                                                          p_leaves)])
            mu = _tree.unflatten(paths, [r[1] for r in results])
            nu = _tree.unflatten(paths, [r[2] for r in results])
        return updates, FusedAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def opt_state_from_numpy(state, device: _device.DeviceLike = None
                         ) -> FusedAdamState:
    """The JAX package's ``FusedAdamState`` with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``), in either mode, as
    the port's: the optimizer half of carrying a run across."""
    device = _device.resolve(device)
    return FusedAdamState(
        count=torch.tensor(int(state.count), dtype=torch.int32),
        mu=_device.from_numpy(state.mu, device),
        nu=_device.from_numpy(state.nu, device))
