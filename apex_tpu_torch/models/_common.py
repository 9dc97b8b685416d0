"""Shared model-zoo init helper (port of ``apex_tpu/models/_common.py``)."""

from __future__ import annotations

import torch


def fan_in_normal(generator: torch.Generator, *shape, fan_in=None,
                  dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) init (fan_in defaults to the second-to-last dim),
    drawn in fp32 on the generator's device, then cast to ``dtype``."""
    scale = (fan_in if fan_in is not None else shape[-2]) ** -0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)
