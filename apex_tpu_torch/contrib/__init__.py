"""apex.contrib parity surface (port of ``apex_tpu/contrib/__init__.py``).

:mod:`fmha`: the fused multi-head attention over the flash kernels
(padded-dense packed qkv, per-sequence lengths, dropout inside the
kernels). :mod:`multihead_attn`: ``SelfMultiheadAttn``,
``EncdecMultiheadAttn`` and ``MaskSoftmaxDropout`` over the flash,
masked-softmax and LayerNorm kernels.
"""

from apex_tpu_torch.contrib import fmha, multihead_attn

__all__ = ["fmha", "multihead_attn"]
