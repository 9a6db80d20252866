"""Hungarian matching for the DETR head (counterpart of
``omnihd_scenes_tpu/models/hungarian.py``; reference
``HungarianAssigner3D``, ``core/bbox/assigners/hungarian_assigner_3d.py:
17-139``, and ``core/bbox/match_costs/match_cost.py``).

The cost is FocalLossCost (weight 2.0) on the sigmoid class
probabilities plus BBox3DL1Cost (weight 0.25) on the first 8 dims of the
normalised code.  Padded GT columns cost ``_BIG`` (as do NaN and +inf
costs; -inf costs ``-_BIG``), so they are matched only where queries
outnumber real GTs, and those matches are masked out afterwards.  scipy's
``linear_sum_assignment`` solves each problem on the host.

:func:`hungarian_match` takes any number of leading problem dimensions
(BEVFormer's loss passes samples x decoder layers): every cost matrix is
built on the inputs' device without gradients (the assignment carries
none), all of them reach the host in one copy, and the matches return in
one copy from pinned memory that does not make the host wait -- one
synchronisation per call however many problems it solves.  The JAX
package's in-graph auction solver is a TPU workaround and is not carried
over.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_BIG = 1e8


def focal_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-12,
               weight: float = 2.0) -> torch.Tensor:
    """(..., nq, C) logits and (..., G) labels -> (..., nq, G) cost
    (mmdet ``FocalLossCost``)."""
    p = torch.sigmoid(cls_logits)
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos_cost = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    # JAX's indexing: a negative label counts from the end, and any label
    # out of range is clamped (only padded slots carry one).
    n_cls = cls_logits.shape[-1]
    labels = gt_labels.long()
    labels = torch.where(labels < 0, labels + n_cls, labels).clamp(
        0, n_cls - 1)
    idx = labels[..., None, :].expand(*cls_logits.shape[:-1],
                                      labels.shape[-1])
    return (torch.gather(pos_cost, -1, idx)
            - torch.gather(neg_cost, -1, idx)) * weight


def bbox_l1_cost(bbox_preds: torch.Tensor, gt_codes: torch.Tensor,
                 weight: float = 0.25) -> torch.Tensor:
    """(..., nq, >= 8) and (..., G, >= 8) -> (..., nq, G) L1 cost on the
    first 8 normalised dims."""
    diff = (bbox_preds[..., :, None, :8] - gt_codes[..., None, :, :8]).abs()
    return diff.sum(-1) * weight


def match_cost(cls_logits, bbox_preds, gt_codes, gt_labels, gt_mask,
               cls_weight: float = 2.0,
               bbox_weight: float = 0.25) -> torch.Tensor:
    """The masked (..., nq, G) assignment cost."""
    cost = (focal_cost(cls_logits, gt_labels, weight=cls_weight)
            + bbox_l1_cost(bbox_preds, gt_codes, weight=bbox_weight))
    cost = torch.where(gt_mask[..., None, :], cost,
                       torch.full_like(cost, _BIG))
    return torch.nan_to_num(cost, nan=_BIG, posinf=_BIG, neginf=-_BIG)


def solve_host(cost: np.ndarray) -> np.ndarray:
    """(..., nq, G) costs -> (..., G) int64 query matched to each GT
    (-1 where none is, when GTs outnumber queries)."""
    from scipy.optimize import linear_sum_assignment

    *lead, _, ng = cost.shape
    flat = cost.reshape(-1, *cost.shape[-2:])
    out = np.full((flat.shape[0], ng), -1, np.int64)
    for i, c in enumerate(flat):
        row, col = linear_sum_assignment(c)
        out[i, col] = row
    return out.reshape(*lead, ng)


@torch.no_grad()
def hungarian_match(cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
                    gt_codes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor, cls_weight: float = 2.0,
                    bbox_weight: float = 0.25
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match queries to padded GTs, one problem per leading index.

    cls_logits (..., nq, C); bbox_preds (..., nq, 10); gt_codes (..., G,
    10); gt_labels (..., G); gt_mask (..., G) bool, where ``...`` is the
    same leading shape for all of them.

    Returns ``matched`` (..., G) int64, the query of each valid GT (-1 for
    padding), and ``pos_mask`` (..., nq) bool, the queries matched to a
    valid GT, both on the inputs' device.
    """
    cost = match_cost(cls_logits, bbox_preds, gt_codes, gt_labels, gt_mask,
                      cls_weight, bbox_weight)
    cost = cost.to(torch.promote_types(cost.dtype, torch.float32))
    host = solve_host(cost.cpu().numpy())               # the one sync
    matched = torch.from_numpy(host)
    if cost.is_cuda:
        matched = matched.pin_memory().to(cost.device, non_blocking=True)
    matched = torch.where(gt_mask, matched, torch.full_like(matched, -1))
    nq = cls_logits.shape[-2]
    slot = torch.where(matched >= 0, matched, torch.full_like(matched, nq))
    pos_mask = torch.zeros(*matched.shape[:-1], nq + 1, dtype=torch.bool,
                           device=matched.device)
    pos_mask.scatter_(-1, slot, True)
    return matched, pos_mask[..., :nq]
