"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no CUDA device present they raise, never carry on on the
CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

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


def memory(device: DeviceLike = None) -> Tuple[int, int]:
    """``(total, used)`` bytes of ``device``'s memory, the counterpart of
    the reference's ``device_hbm_bytes`` (``ops/pallas_config.py:293``):
    on a CUDA device the total and total - free of one
    ``torch.cuda.mem_get_info`` call (used counts every byte resident on
    the card, the weights too). ``APEX_TPU_HBM_BYTES`` overrides the
    total, as in the reference. A CPU device has no such memory: with the
    override it reports the override and 0 used, without it it raises,
    never returning a planning figure."""
    device = resolve(device)
    env = os.environ.get("APEX_TPU_HBM_BYTES")
    override = None
    if env:
        try:
            override = int(env)
        except ValueError:
            raise ValueError(f"APEX_TPU_HBM_BYTES must be an integer byte "
                             f"count, got {env!r}")
    if device.type != "cuda":
        if override is None:
            raise RuntimeError(
                f"no device memory to read on {device}: pass hbm_bytes or "
                f"set APEX_TPU_HBM_BYTES")
        return override, 0
    free, total = torch.cuda.mem_get_info(device)
    return (total if override is None else override), total - free


def _same(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device
    return (a.index if a.index is not None else current()) == (
        b.index if b.index is not None else current())


def generator_on(generator: torch.Generator,
                 device: torch.device) -> torch.Generator:
    """A generator that draws on ``device``: ``generator`` itself when it
    lies there, else a new one on ``device`` seeded with one number
    drawn from ``generator`` (so a CPU generator never moves a tensor's
    random draws, nor their copy, off the card)."""
    if _same(generator.device, device):
        return generator
    seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


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
