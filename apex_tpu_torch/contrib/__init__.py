"""apex.contrib parity surface (port of ``apex_tpu/contrib/__init__.py``).

:mod:`fmha`: the fused multi-head attention over the flash kernels
(padded-dense packed qkv, per-sequence lengths, dropout inside the
kernels). :mod:`multihead_attn`: ``SelfMultiheadAttn``,
``EncdecMultiheadAttn`` and ``MaskSoftmaxDropout`` over the flash,
masked-softmax and LayerNorm kernels. :mod:`clip_grad`: the global-norm
gradient clip. :mod:`optimizers`: the contrib ``FP16_Optimizer`` and the
legacy fused optimizers.
"""

from apex_tpu_torch.contrib import clip_grad, fmha, multihead_attn, optimizers

__all__ = ["clip_grad", "fmha", "multihead_attn", "optimizers"]
