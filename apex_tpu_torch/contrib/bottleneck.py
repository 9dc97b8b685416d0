"""ResNet bottlenecks for detection backbones (port of
``apex_tpu/contrib/bottleneck.py``; ref apex/contrib/bottleneck/
bottleneck.py ``Bottleneck``, ``SpatialBottleneck``,
``FrozenBatchNorm2d``).

- :class:`Bottleneck` is ``models/resnet.py``'s, re-exported.
- :class:`SpatialBottleneck` runs one bottleneck on a feature map split
  along H over the group bound to ``axis_name``: the stride on the first
  1x1 (``stride_1x1``, as the reference's spatial path forces), the 3x3
  on the local slab padded by one row each side, the rows exchanged with
  the neighbours (:func:`~apex_tpu_torch.contrib.peer_memory.
  halo_exchange_1d`), convolved VALID over H and SAME over W. Its
  variables are ``Bottleneck(stride_1x1=True)``'s, so one device's
  block on the whole map and the split block take one tree.
- :class:`FrozenBatchNorm2d`: fixed statistics folded into one scale and
  bias.

Functional over variables trees, as ``models/resnet.py`` is: OIHW
kernels, NHWC activations at the API, NCHW order in ``channels_last``
memory inside.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.contrib.peer_memory import halo_exchange_1d
from apex_tpu_torch.models._common import BatchNorm
from apex_tpu_torch.models.resnet import Bottleneck, _to_nchw, conv

__all__ = ["Bottleneck", "FrozenBatchNorm2d", "SpatialBottleneck"]


@dataclasses.dataclass(frozen=True)
class SpatialBottleneck:
    """The bottleneck on an H-sharded map (ref ``:25-73``). ``sync_bn``
    merges each BatchNorm's statistics over the group bound to
    ``bn_axis`` (bind it to the spatial group for the whole map's
    statistics)."""

    features: int
    strides: Tuple[int, int] = (1, 1)
    axis_name: str = "spatial"
    sync_bn: bool = False
    bn_axis: Optional[str] = "data"

    def block(self) -> Bottleneck:
        """The one-device block with the same variables."""
        return Bottleneck(self.features, self.strides, self.sync_bn,
                          self.bn_axis, stride_1x1=True)

    def init(self, generator: torch.Generator, in_features: int,
             device: _device.DeviceLike = None) -> Dict:
        return self.block().init(generator, in_features, device)

    def forward(self, params, stats, x, train: bool):
        """``(y, new_stats)`` on this rank's NCHW-ordered slab ``x``."""
        bn = BatchNorm(sync=self.sync_bn, axis_name=self.bn_axis)
        new = {}

        def norm(name, y):
            y, new[name] = bn(params[name], stats[name], y, train, ch=1)
            return y

        y = conv(x, params["Conv_0"]["kernel"], self.strides)
        y = F.relu(norm("BatchNorm_0", y))
        # the 3x3 on the slab: a one-row halo each side, filled from the
        # neighbours, then VALID over H and SAME (1) over W
        y = halo_exchange_1d(F.pad(y, (0, 0, 1, 1)), 1, self.axis_name,
                             h_dim=2)
        y = F.conv2d(y, params["Conv_1"]["kernel"].to(y.dtype),
                     padding=(0, 1))
        y = F.relu(norm("BatchNorm_1", y))
        y = norm("BatchNorm_2", conv(y, params["Conv_2"]["kernel"]))
        residual = x
        if residual.shape != y.shape:
            residual = norm("BatchNorm_3", conv(
                x, params["Conv_3"]["kernel"], self.strides))
        return F.relu(y + residual), new

    def apply(self, variables, x, train: bool = True):
        """``(y, new_batch_stats)`` on this rank's NHWC slab ``x``."""
        y, new = self.forward(variables["params"], variables["batch_stats"],
                              _to_nchw(x), train)
        return y.permute(0, 2, 3, 1), new


@dataclasses.dataclass(frozen=True)
class FrozenBatchNorm2d:
    """BatchNorm with fixed statistics and affine params (ref
    ``:76-114``): the four buffers live under ``"frozen"``, never touched
    by an optimizer; the layer is ``x * scale + bias`` with ``scale =
    weight * rsqrt(running_var + eps)`` and ``bias = bias -
    running_mean * scale``."""

    n: int
    eps: float = 1e-5

    def init(self, device: _device.DeviceLike = None) -> Dict:
        """weight 1, bias 0, mean 0, var 1, fp32 on ``device`` (default:
        the GPU, raising when there is none)."""
        dev = _device.resolve(device)

        def full(value):
            return torch.full((self.n,), value, dtype=torch.float32,
                              device=dev)

        return {"frozen": {"weight": full(1.0), "bias": full(0.0),
                           "running_mean": full(0.0),
                           "running_var": full(1.0)}}

    def get_scale_bias(self, variables, nhwc: bool = True):
        """The folded ``(scale, bias)``, shaped to broadcast over NHWC (or
        NCHW): the one place the fold lives."""
        f = variables["frozen"]
        scale = f["weight"] * torch.rsqrt(f["running_var"] + self.eps)
        bias = f["bias"] - f["running_mean"] * scale
        shape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
        return scale.reshape(shape), bias.reshape(shape)

    def apply(self, variables, x, nhwc: bool = True):
        scale, bias = self.get_scale_bias(variables, nhwc)
        return x * scale.to(x.dtype) + bias.to(x.dtype)
