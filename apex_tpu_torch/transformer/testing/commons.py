"""Shared fixtures of the transformer tests (port of
``apex_tpu/transformer/testing/commons.py``, after Apex's
``apex/transformer/testing/commons.py``): the toy stage model (Apex's
``MyLayer``/``MyModel``: a square weight and a bias a layer), the
forward-step function in the schedules' shape, seeds, and the process
groups of ``parallel_state``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import _device
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state


# ------------------------------------------------------------- toy model

def init_toy_stage_params(generator: torch.Generator, hidden_size: int,
                          layers_per_stage: int = 1,
                          device: _device.DeviceLike = None):
    """A stage's params of Apex's ``MyModel`` shape: ``{"w": [L, h, h],
    "b": [L, h]}``, N(0, 0.01) from ``generator`` (drawn on its device),
    on ``device`` (default: the GPU, raising when there is none)."""
    device = _device.resolve(device)
    shapes = {"w": (layers_per_stage, hidden_size, hidden_size),
              "b": (layers_per_stage, hidden_size)}
    return {k: (torch.randn(s, generator=generator,
                            device=generator.device) * 0.1).to(device)
            for k, s in shapes.items()}


def toy_stage_fn(stage_params, x):
    """Apex's ``MyLayer`` forward (``x @ w + b``) for each of the stage's
    layers in turn."""
    for w, b in zip(stage_params["w"], stage_params["b"]):
        x = x @ w + b
    return x


def model_provider_func(hidden_size, pre_process=True, post_process=True):
    """``commons.py:70``: ``(init_fn, stage_fn)`` for one stage; every
    stage takes and gives the same shape, so the first and last need
    nothing of their own."""
    del pre_process, post_process

    def init_fn(generator, layers_per_stage=1, device=None):
        return init_toy_stage_params(generator, hidden_size,
                                     layers_per_stage, device)

    return init_fn, toy_stage_fn


def process_batch(batch):
    """``commons.py:74``: ``(x,)`` or ``x`` -> ``x``."""
    if isinstance(batch, (list, tuple)):
        return batch[0]
    return batch


def fwd_step_func(batch, stage_params):
    """``commons.py:82``: the stage's output and its loss closure, in the
    schedules' forward-step shape."""
    y = toy_stage_fn(stage_params, process_batch(batch))

    def loss_func(y):
        loss = torch.mean(y * y)
        return loss, {"avg": loss}

    return y, loss_func


class IdentityLayer:
    """``commons.py:96``: a trainable tensor behind an identity call."""

    def __init__(self, generator: torch.Generator, shape, scale=1.0,
                 device: _device.DeviceLike = None):
        device = _device.resolve(device)
        self.weight = (scale * torch.randn(
            shape, generator=generator, device=generator.device)).to(device)

    def __call__(self):
        return self.weight


# ------------------------------------------ stage splitting (model zoo)

def split_stages(params, n_stages: int):
    """A model-zoo params tree's stacked ``[L, ...]`` layers as
    ``[n_stages, L / n_stages, ...]`` views (shared by the standalone
    GPT and BERT modules)."""
    layers = params["layers"]
    n = next(iter(layers.values())).shape[0]
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    return {k: v.reshape(n_stages, n // n_stages, *v.shape[1:])
            for k, v in layers.items()}


def io_params(params):
    """The params every stage may read: embeddings, final norms, heads."""
    return {k: v for k, v in params.items() if k != "layers"}


# ------------------------------------------------------------ environment

def set_random_seed(seed: int) -> torch.Generator:
    """``commons.py:105``: one seed for numpy, torch's default generator
    and the returned one."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def build_mesh(shape: Sequence[int], axis_names: Sequence[str]
               ) -> parallel_state.Mesh:
    """The grid ``shape`` over ``axis_names`` (rank order as
    ``parallel_state``'s, the last axis fastest), checked against the
    started world's size; no groups are made
    (:func:`initialize_distributed` binds them)."""
    n = int(np.prod(shape))
    world = _backend.get_world_size() if _backend.is_initialized() else 1
    if n != world:
        raise RuntimeError(f"a grid of {n} ranks over a world of {world}")
    return parallel_state.Mesh(dict(zip(axis_names, (int(s)
                                                     for s in shape))))


def initialize_distributed(tp: int = 1, pp: int = 1, cp: int = 1,
                           backend: Optional[str] = None
                           ) -> parallel_state.Mesh:
    """``commons.py:113``: start ``torch.distributed`` from the launcher's
    environment if it is not started (``parallel.multiproc``), then bind
    the tp/pp/cp/dp groups (``parallel_state.initialize_model_parallel``,
    dp what is left of the world). ``backend`` is the groups'."""
    if not _backend.is_initialized():
        from apex_tpu_torch.parallel.multiproc import (
            initialize_distributed as start,
        )

        start(backend=backend)
    world = _backend.get_world_size()
    if world % (tp * pp * cp):
        raise RuntimeError(f"tp*pp*cp ({tp * pp * cp}) must divide the "
                           f"world size ({world})")
    parallel_state.destroy_model_parallel()
    return parallel_state.initialize_model_parallel(
        tp, pp, context_parallel_size_=cp, backend=backend)


def print_separator(message: str):
    """``commons.py:148``."""
    print("\n" + "-" * 31 + f" {message} " + "-" * 31, flush=True)
