"""ResNet family (port of ``apex_tpu/models/resnet.py``): the reference's
imagenet example model, ResNet-50 at amp O2 with DDP and an optional
SyncBatchNorm.

Functional over a variables tree ``{"params", "batch_stats"}`` keyed by
flax's module paths (``Conv_0``, ``BatchNorm_0/BatchNorm_0``,
``Bottleneck_3/Conv_1``, ``Dense_0``, ...), so amp's ``cast_model``
keeps every ``BatchNorm_*`` leaf fp32 as the reference's does. Two
deliberate differences in the tree: conv kernels are OIHW (PyTorch's
``conv2d`` layout; :func:`variables_from_flax` permutes flax's HWIO once),
Dense kernels stay ``[in, out]``.

The API takes NHWC images, as the reference does. Inside, activations are
in NCHW logical order with ``torch.channels_last`` memory: an NHWC
tensor permuted to NCHW is channels_last as it lies, so no copy is made,
and cuDNN runs its NHWC convolutions. Padding is flax's ``SAME``: with
stride 2 on an even size it is asymmetric (low ``total // 2``, high the
rest), so the 7x7/2 stem pads (2, 3), a downsampling 3x3/2 pads (0, 1)
and the 3x3/2 max pool pads (0, 1) with -inf; such convolutions pad with
``F.pad`` and convolve with ``padding=0`` (PyTorch's symmetric padding
would shift every window by a pixel). Convolutions, pooling and the
BatchNorm (``models/_common.BatchNorm``) are plain PyTorch, as the
reference's are XLA ops outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models._common import BatchNorm

# flax's lecun_normal: a normal truncated at +-2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: ``(low, high)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1)):
    """``nn.Conv(padding="SAME", use_bias=False)`` on NCHW-ordered ``x``
    with an OIHW ``kernel`` cast to ``x``'s dtype."""
    kh, kw = kernel.shape[2:]
    (t, b), (l, r) = (_same_pads(x.shape[2], kh, strides[0]),
                      _same_pads(x.shape[3], kw, strides[1]))
    w = kernel.to(x.dtype)
    if t == b and l == r:
        return F.conv2d(x, w, stride=strides, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=strides)


def max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: the
    pad is -inf, so it never wins."""
    (t, b), (l, r) = (_same_pads(x.shape[2], k, s),
                      _same_pads(x.shape[3], k, s))
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), k, s)


def lecun_normal(generator: torch.Generator, shape, fan_in: int,
                 device) -> torch.Tensor:
    """flax's default kernel init (``variance_scaling(1, "fan_in",
    "truncated_normal")``), drawn in fp32 on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(fan_in ** -0.5 / _TRUNC_STD).to(device)


def _conv_kernel(generator, cin: int, cout: int, k: int, device):
    return {"kernel": lecun_normal(generator, (cout, cin, k, k),
                                   cin * k * k, device)}


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """1x1 -> 3x3 -> 1x1 bottleneck (``resnet.py:23``). ``stride_1x1``
    moves the downsampling stride from the 3x3 (ResNet v1.5, the default)
    onto the first 1x1 (v1). A residual whose shape differs from the
    block's output goes through a strided 1x1 and its own BatchNorm
    (``Conv_3``, ``BatchNorm_3``)."""

    features: int
    strides: Tuple[int, int] = (1, 1)
    sync_bn: bool = False
    axis_name: Optional[str] = "data"
    stride_1x1: bool = False

    def _bn(self) -> BatchNorm:
        return BatchNorm(sync=self.sync_bn, axis_name=self.axis_name)

    def projects(self, in_features: int) -> bool:
        """Whether the residual needs the 1x1 projection."""
        return (in_features != self.features * 4
                or tuple(self.strides) != (1, 1))

    def init(self, generator: torch.Generator, in_features: int,
             device=None) -> Dict:
        """The block's variables, fp32, flax's inits."""
        device = _device.resolve(device)
        f = self.features
        params, stats = {}, {}
        shapes = [(in_features, f, 1), (f, f, 3), (f, 4 * f, 1)]
        if self.projects(in_features):
            shapes.append((in_features, 4 * f, 1))
        for i, (cin, cout, k) in enumerate(shapes):
            params[f"Conv_{i}"] = _conv_kernel(generator, cin, cout, k,
                                               device)
            params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = \
                self._bn().init(cout, device)
        return {"params": params, "batch_stats": stats}

    def forward(self, params, stats, x, train: bool):
        """``(y, new_stats)`` on NCHW-ordered ``x``."""
        bn = self._bn()
        new = {}

        def norm(name, y):
            y, new[name] = bn(params[name], stats[name], y, train, ch=1)
            return y

        s1 = self.strides if self.stride_1x1 else (1, 1)
        s3 = (1, 1) if self.stride_1x1 else self.strides
        y = conv(x, params["Conv_0"]["kernel"], s1)
        y = F.relu(norm("BatchNorm_0", y), inplace=True)
        y = conv(y, params["Conv_1"]["kernel"], s3)
        y = F.relu(norm("BatchNorm_1", y), inplace=True)
        y = conv(y, params["Conv_2"]["kernel"])
        y = norm("BatchNorm_2", y)
        residual = x
        if residual.shape != y.shape:
            residual = conv(x, params["Conv_3"]["kernel"], self.strides)
            residual = norm("BatchNorm_3", residual)
        return F.relu(y + residual, inplace=True), new

    def apply(self, variables, x, train: bool = True):
        """``(y, new_batch_stats)`` on NHWC ``x``, as the reference's
        block takes it."""
        y, new = self.forward(variables["params"], variables["batch_stats"],
                              _to_nchw(x), train)
        return y.permute(0, 2, 3, 1), new


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW order in channels_last memory (a view when ``x`` is
    NHWC-contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class ResNet:
    """``resnet.py:61``: a 7x7/2 stem, BatchNorm, ReLU, a 3x3/2 max pool,
    ``stage_sizes`` bottlenecks a stage (the first of each later stage
    strided), the spatial mean and a ``Dense`` in fp32. ``dtype`` is the
    activations' (and the convolutions'); the params come as given."""

    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    sync_bn: bool = False
    axis_name: Optional[str] = "data"
    dtype: torch.dtype = torch.bfloat16

    def blocks(self):
        """``(name, Bottleneck, in_features)`` of every block, in order."""
        out, cin, k = [], self.width, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = Bottleneck(self.width * 2 ** i, strides,
                                   self.sync_bn, self.axis_name)
                out.append((f"Bottleneck_{k}", block, cin))
                cin, k = block.features * 4, k + 1
        return out

    def _bn(self) -> BatchNorm:
        return BatchNorm(sync=self.sync_bn, axis_name=self.axis_name)

    def apply(self, variables, x, train: bool = True):
        """``(logits, new_batch_stats)`` for NHWC images ``x``; logits
        fp32. In eval mode the batch stats come back as they are."""
        params, stats = variables["params"], variables["batch_stats"]
        x = _to_nchw(x.to(self.dtype))
        x = conv(x, params["Conv_0"]["kernel"], (2, 2))
        x, new = self._bn()(params["BatchNorm_0"], stats["BatchNorm_0"], x,
                            train, ch=1)
        new_stats = {"BatchNorm_0": new}
        x = max_pool(F.relu(x, inplace=True))
        for name, block, _ in self.blocks():
            x, new_stats[name] = block.forward(params[name], stats[name], x,
                                               train)
        x = x.mean((2, 3))
        dense = params["Dense_0"]
        logits = x.float() @ dense["kernel"].float() + dense["bias"].float()
        return logits, (new_stats if train else stats)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def tiny(**kw) -> ResNet:
    """Test-scale: one block a stage, two stages, width 8, fp32."""
    kw.setdefault("stage_sizes", (1, 1))
    kw.setdefault("width", 8)
    kw.setdefault("num_classes", 10)
    kw.setdefault("dtype", torch.float32)
    return ResNet(**kw)


def init_variables(generator: torch.Generator, model: ResNet,
                   device: _device.DeviceLike = None) -> Dict:
    """Random variables from ``generator`` (drawn on its device) with
    flax's default laws (lecun-normal kernels, zero biases, BatchNorm
    scale 1, bias 0, mean 0, var 1), fp32, placed on ``device`` (default:
    the GPU, raising when there is none). The same laws as the
    reference's init, not the same bits."""
    device = _device.resolve(device)
    bn = model._bn()
    params = {"Conv_0": _conv_kernel(generator, 3, model.width, 7, device)}
    params["BatchNorm_0"], stats0 = bn.init(model.width, device)
    stats = {"BatchNorm_0": stats0}
    for name, block, cin in model.blocks():
        v = block.init(generator, cin, device)
        params[name], stats[name] = v["params"], v["batch_stats"]
    cin = model.blocks()[-1][1].features * 4
    params["Dense_0"] = {
        "kernel": lecun_normal(generator, (cin, model.num_classes), cin,
                               device),
        "bias": torch.zeros(model.num_classes, dtype=torch.float32,
                            device=device)}
    return {"params": params, "batch_stats": stats}


def _from_flax(tree):
    if isinstance(tree, dict):
        return {k: (np.transpose(np.asarray(v), (3, 2, 0, 1))
                    if k == "kernel" and np.ndim(v) == 4 else _from_flax(v))
                for k, v in tree.items()}
    return tree


def variables_from_flax(variables, device: _device.DeviceLike = None
                        ) -> Dict:
    """The JAX package's ResNet variables with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, variables)``) as the port's:
    conv kernels permuted HWIO -> OIHW once, everything else (Dense
    kernels ``[in, out]``, the running stats) as it is."""
    return _device.from_numpy(_from_flax(variables), _device.resolve(device))
