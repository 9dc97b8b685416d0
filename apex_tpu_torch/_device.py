"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no CUDA device present they raise, never carry on on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: apex_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda", torch.cuda.current_device())


def of(tree) -> Optional[torch.device]:
    """The device of the first tensor found in a nested dict of
    tensors (the params layout), or None for an empty tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for value in tree.values():
            dev = of(value)
            if dev is not None:
                return dev
    return None


def _tensor_from_numpy(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the source may be read-only
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin
        t = torch.from_numpy(arr.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_numpy(tree, device: torch.device):
    """A nested dict of numpy arrays (the JAX package's params or
    optimizer state, pulled to the host) as tensors on ``device``, with
    no reshape; bf16 arrays convert bit for bit."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree, device)
