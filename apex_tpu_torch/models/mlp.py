"""Simple MLP (port of ``apex_tpu/models/mlp.py``): the reference's
``apex.mlp.MLP`` benchmark model and the O1 "simple" example config.

Params keep the reference's layout, ``{"layers": [{"w", "b"}, ...]}``
(a list, as the JAX package's tree has it), so :func:`params_from_numpy`
takes the JAX package's params as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models._common import fan_in_normal


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    sizes: Sequence[int] = (784, 1024, 1024, 10)
    activation: str = "relu"  # relu | sigmoid | none (ref mlp.py activation)
    bias: bool = True
    dtype: torch.dtype = torch.float32


def init_params(generator: torch.Generator, cfg: MLPConfig,
                device: _device.DeviceLike = None) -> Dict:
    """Random params from ``generator`` (drawn on its device), placed on
    ``device`` (default: the GPU, raising when there is none): each
    kernel N(0, 1/fan_in), each bias 0, as the reference's laws."""
    device = _device.resolve(device)
    layers = []
    for fan_in, fan_out in zip(cfg.sizes[:-1], cfg.sizes[1:]):
        layer = {"w": fan_in_normal(generator, fan_in, fan_out,
                                    dtype=cfg.dtype).to(device)}
        if cfg.bias:
            layer["b"] = torch.zeros((fan_out,), dtype=cfg.dtype,
                                     device=device)
        layers.append(layer)
    return {"layers": layers}


def params_from_numpy(tree, device: _device.DeviceLike = None) -> Dict:
    """The JAX package's params with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's."""
    device = _device.resolve(device)
    return {"layers": [_device.from_numpy(layer, device)
                       for layer in tree["layers"]]}


def _act(x, name: str):
    if name == "relu":
        return F.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "none":
        return x
    raise ValueError(f"unknown activation {name!r} (relu|sigmoid|none)")


def forward(params, x, cfg: MLPConfig):
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = torch.matmul(x, layer["w"])
        if "b" in layer:
            x = x + layer["b"]
        if i < n - 1:
            x = _act(x, cfg.activation)
    return x


def loss_fn(params, batch, cfg: MLPConfig):
    """Softmax CE on integer labels; ``batch = (x, y)``."""
    x, y = batch
    logits = forward(params, x, cfg).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None].long()))
