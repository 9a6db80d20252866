"""Loss functions (counterpart of ``omnihd_scenes_tpu/models/losses.py``):
element-wise, mask-weighted by the caller.

mmdet's sigmoid ``FocalLoss`` (gamma 2, alpha 0.25), ``SmoothL1Loss``
(beta 1/9) and the softmax cross-entropy of the direction classifier, as
the reference anchor-head configs wire them.
"""

from __future__ import annotations

import torch


def sigmoid_focal_loss(logits, one_hot_targets, gamma: float = 2.0,
                       alpha: float = 0.25):
    """Element-wise sigmoid focal loss (the shape of ``logits``)."""
    p = torch.sigmoid(logits)
    t = one_hot_targets
    ce = torch.logaddexp(torch.zeros_like(logits), logits) - logits * t
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return alpha_t * (1 - p_t) ** gamma * ce


def smooth_l1(pred, target, beta: float = 1.0 / 9.0):
    """Element-wise smooth L1 (Huber) loss; ``/ beta`` as jitted JAX
    computes it (a multiply by ``1 / beta``)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff * (1.0 / beta),
                       diff - 0.5 * beta)


def softmax_cross_entropy(logits, labels):
    """Per-element CE of logits (..., K) at integer labels (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]
