"""Multi-tensor reductions (port of
``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``).

Plain PyTorch: the JAX package computes these with ``jnp`` outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def multi_tensor_l2norm(tensor_list: Sequence[torch.Tensor],
                        per_tensor: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Global (and optionally per-tensor) L2 norm, squares summed in fp32
    (``multi_tensor_apply.py:64``). Returns ``(global_norm,
    per_tensor_norms | None)`` as fp32 tensors. Each tensor is reduced on
    its own, so no concatenated copy of the list is made; the sums differ
    from one pass over the concatenation in order only."""
    squares = torch.stack([torch.sum(torch.square(t.float()))
                           for t in tensor_list])
    total = torch.sqrt(torch.sum(squares))
    return total, torch.sqrt(squares) if per_tensor else None
