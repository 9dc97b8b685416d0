"""NHWC BatchNorm with a fused ReLU or add+ReLU and cross-rank groups
(port of ``apex_tpu/contrib/groupbn.py``; ref apex/contrib/groupbn/
batch_norm.py ``BatchNorm2d_NHWC``).

Functional over a variables tree, as ``models/resnet.py`` is: ``init``
gives ``{"params", "batch_stats"}`` keyed as the reference's flax module
nests them (``BatchNorm_0`` for ``bn_group`` 1, ``SyncBatchNorm_0``
above), ``apply`` the output and the new stats. Both of the reference's
branches, over ``models/_common.BatchNorm``:

- ``bn_group == 1``: flax's ``nn.BatchNorm`` with ``momentum`` the
  fraction KEPT (``groupbn.py:44``), the biased batch variance;
- ``bn_group > 1``: the port's SyncBatchNorm over the group bound to
  ``axis_name``, groups of ``bn_group`` consecutive ranks sharing
  statistics, with momentum ``1 - momentum`` (the fraction replaced,
  ``groupbn.py:39``) and the unbiased running variance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models._common import BatchNorm


@dataclasses.dataclass(frozen=True)
class BatchNorm2d_NHWC:
    """ref ``batch_norm.py:101``: ``fuse_relu`` applies the ReLU after
    the normalisation; ``apply(variables, x, z)`` adds ``z`` and applies
    the ReLU (the bn_addrelu path). The channel dim is the last."""

    num_features: int
    fuse_relu: bool = False
    bn_group: int = 1
    axis_name: Optional[str] = "data"
    momentum: float = 0.9
    eps: float = 1e-5

    def _bn(self) -> BatchNorm:
        sync = self.bn_group > 1
        return BatchNorm(sync=sync, axis_name=self.axis_name,
                         momentum=self.momentum, eps=self.eps,
                         group_size=self.bn_group if sync else None)

    def init(self, device: _device.DeviceLike = None) -> Dict:
        """Scale 1, bias 0, mean 0, var 1 in fp32 on ``device`` (default:
        the GPU, raising when there is none)."""
        params, stats = self._bn().init(self.num_features,
                                        _device.resolve(device))
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x: torch.Tensor,
              z: Optional[torch.Tensor] = None, train: bool = True):
        """``(y, new_batch_stats)`` for NHWC ``x`` (``z`` like ``x``); in
        eval mode the stats come back as they are."""
        y, stats = self._bn()(variables["params"], variables["batch_stats"],
                              x, train, ch=-1)
        if z is not None:
            y = y + z
        if self.fuse_relu or z is not None:
            y = F.relu(y)
        return y, stats
