"""apex.contrib parity surface (port of ``apex_tpu/contrib/__init__.py``).

Ported so far: :mod:`fmha`, the fused multi-head attention over the
flash kernels (padded-dense packed qkv, per-sequence lengths, dropout
inside the kernels). ``multihead_attn`` is not ported yet and raises
``NotImplementedError``.
"""

from apex_tpu_torch.contrib import fmha

__all__ = ["fmha"]


def __getattr__(name):
    if name == "multihead_attn":
        raise NotImplementedError(
            "apex_tpu_torch.contrib.multihead_attn is not ported yet: it "
            "is the next module of ROADMAP.md's Queue 1")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
