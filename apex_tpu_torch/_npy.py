"""Tensors as numpy arrays that either package reads: float32 and the
integer dtypes as they are, bf16 as 2-byte ``|V2`` items holding the
bf16 bits (what ``np.save``/``np.savez`` write for the reference's
``ml_dtypes`` bf16 arrays, and what numpy alone reads without
``ml_dtypes``). The serving dump's pages and the checkpoints' leaves
use them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dump_array", "load_array"]


def dump_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the dump's numpy array: bf16 as ``|V2`` items
    holding its bits (a view of int16, no conversion), other dtypes as
    they are."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def load_array(a, dtype: torch.dtype) -> torch.Tensor:
    """A dump's numpy array (or a tensor) as a host tensor of ``dtype``:
    ``|V2`` items are bf16 bits (the reference's ``ml_dtypes`` bf16
    through ``np.savez``, or :func:`dump_array`'s), read bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a raw dump array must hold 2-byte bf16 items, "
                            f"got {a.dtype}")
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if t.dtype != dtype and not (t.dtype.is_floating_point
                                 and dtype.is_floating_point):
        raise TypeError(f"a dump array of {t.dtype} cannot be read as {dtype}")
    return t.to(dtype)
