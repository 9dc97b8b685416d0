"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no CUDA device present they raise, never carry on on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

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
