"""Sigmoid focal loss (port of ``apex_tpu/contrib/focal_loss.py``; ref
apex/contrib/focal_loss/focal_loss.py ``focal_loss_cuda``).

RetinaNet's classification loss over one-hot class targets: label
smoothing, only the first ``num_real_classes`` channels of a padded
class dim, normalised by the number of positives. Plain PyTorch with
ordinary autograd, as the reference is ``jnp`` with AD.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss(cls_output, cls_targets_at_level, num_positives_sum,
               num_real_classes: int, alpha: float, gamma: float,
               label_smoothing: float = 0.0):
    """Scalar focal loss (ref ``focal_loss.py:15-39``).

    ``cls_output``: ``[..., C_padded]`` logits; ``cls_targets_at_level``:
    ``[...]`` int class ids, -1 a background anchor (no positive class;
    its channels still give the negative-class loss). Only the first
    ``num_real_classes`` channels count; smoothing makes the targets
    ``onehot (1 - s) + s / 2``; the sum is divided by
    ``max(num_positives_sum, 1)``. Computed in fp32."""
    logits = cls_output[..., :num_real_classes].float()
    t = cls_targets_at_level
    onehot = F.one_hot(torch.clamp(t, min=0).long(),
                       num_real_classes).to(torch.float32)
    onehot = onehot * (t >= 0)[..., None]
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * onehot
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    loss = alpha_t * (1.0 - p_t) ** gamma * ce
    num = torch.as_tensor(num_positives_sum, dtype=torch.float32,
                          device=loss.device)
    return loss.sum() / torch.clamp(num, min=1.0)


class FocalLoss:
    """ref ``focal_loss.py:4`` FocalLoss (``Function.apply`` shape)."""

    apply = staticmethod(focal_loss)

    def __call__(self, *args, **kwargs):
        return focal_loss(*args, **kwargs)
