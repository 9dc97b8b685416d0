"""apex.contrib parity surface (port of ``apex_tpu/contrib/__init__.py``).

:mod:`fmha`: the fused multi-head attention over the flash kernels.
:mod:`multihead_attn`: ``SelfMultiheadAttn``, ``EncdecMultiheadAttn`` and
``MaskSoftmaxDropout`` over the flash, masked-softmax and LayerNorm
kernels. :mod:`layer_norm`: ``FastLayerNorm`` over the LayerNorm
kernels. :mod:`xentropy` (label-smoothing cross entropy),
:mod:`focal_loss`, :mod:`conv_bias_relu`, :mod:`groupbn` (NHWC
BatchNorm, cross-rank groups), :mod:`bottleneck` (the spatially split
bottleneck, ``FrozenBatchNorm2d``), :mod:`peer_memory` and
:mod:`halo_exchangers` (halo exchange over ``torch.distributed``),
:mod:`sparsity` (ASP), :mod:`transducer` (RNN-T joint and loss) and
:mod:`clip_grad`: plain PyTorch. :mod:`optimizers`: the contrib
``FP16_Optimizer``, the legacy fused optimizers and the ZeRO-sharded
``DistributedFusedAdam`` (on the flat Adam kernel) and
``DistributedFusedLAMB``.
"""

from apex_tpu_torch.contrib import (
    bottleneck,
    clip_grad,
    conv_bias_relu,
    fmha,
    focal_loss,
    groupbn,
    halo_exchangers,
    layer_norm,
    multihead_attn,
    optimizers,
    peer_memory,
    sparsity,
    transducer,
    xentropy,
)

__all__ = [
    "bottleneck", "clip_grad", "conv_bias_relu", "fmha", "focal_loss",
    "groupbn", "halo_exchangers", "layer_norm", "multihead_attn",
    "optimizers", "peer_memory",
    "sparsity", "transducer", "xentropy",
]
