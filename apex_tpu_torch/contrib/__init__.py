"""apex.contrib parity surface (port of ``apex_tpu/contrib/__init__.py``).

Ported so far: :mod:`fmha`, the fused multi-head attention over the
flash kernels (padded-dense packed qkv, per-sequence lengths, dropout
inside the kernels).
"""

from apex_tpu_torch.contrib import fmha

__all__ = ["fmha"]
