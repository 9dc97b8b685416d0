"""Convolution + bias (+ ReLU, + mask, + frozen scale) (port of
``apex_tpu/contrib/conv_bias_relu.py``; ref apex/contrib/conv_bias_relu/
conv_bias_relu.py, cuDNN's fused runner).

The reference's API as it is: NHWC activations, HWIO kernels, the bias
(and scale) over channels, symmetric ``padding``. Inside, as
``models/resnet.py`` does it, the kernel is permuted to PyTorch's OIHW
and the activations run in NCHW order with ``channels_last`` memory (an
NHWC tensor permuted is that layout as it lies), so cuDNN runs its NHWC
convolution and the epilogue is plain PyTorch, as the reference's is an
XLA fusion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.resnet import _to_nchw

__all__ = ["ConvBias", "ConvBiasMaskReLU", "ConvBiasReLU",
           "ConvFrozenScaleBiasReLU"]


def _kernel_oihw(weight: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as OIHW in ``channels_last`` memory (the layout
    ``models/resnet.py``'s ``variables_from_flax`` stores)."""
    return weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _conv(x, weight, padding: int, stride: int) -> torch.Tensor:
    """NHWC ``x`` with an HWIO ``weight`` -> NHWC (a view of the
    channels_last NCHW result)."""
    y = F.conv2d(_to_nchw(x), _kernel_oihw(weight).to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def ConvBias(x, weight, bias, padding: int = 0, stride: int = 1):
    """ref ``ConvBias_`` (``conv_bias_relu.py:56``)."""
    return _conv(x, weight, padding, stride) + bias


def ConvBiasReLU(x, weight, bias, padding: int = 0, stride: int = 1):
    """ref ``ConvBiasReLU_`` (``conv_bias_relu.py:12``)."""
    return F.relu(ConvBias(x, weight, bias, padding, stride))


def ConvBiasMaskReLU(x, weight, bias, mask, padding: int = 0,
                     stride: int = 1):
    """ref ``ConvBiasMaskReLU_`` (``conv_bias_relu.py:34``): the mask
    multiplies before the ReLU."""
    return F.relu(ConvBias(x, weight, bias, padding, stride) * mask)


def ConvFrozenScaleBiasReLU(x, weight, scale, bias, padding: int = 0,
                            stride: int = 1):
    """ref ``ConvFrozenScaleBiasReLU_``: the convolution, then a frozen
    BatchNorm's affine, then the ReLU."""
    return F.relu(_conv(x, weight, padding, stride) * scale + bias)
