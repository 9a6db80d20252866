"""Max-IoU anchor-target assignment (counterpart of
``omnihd_scenes_tpu/models/target_assign.py``), batched.

mmdet ``MaxIoUAssigner`` on ``BboxOverlapsNearest3D`` as the reference
wires it: pos_iou_thr 0.6, neg_iou_thr 0.3, min_pos_iou 0.3, and each
valid GT claims the anchors that reach its best IoU, the last claimant
winning.  GT boxes arrive padded, (B, G, 9) with a validity mask; invalid
rows never match.  Ties between equal IoUs take the first index, as
``argmax`` does in both packages.  Nothing here needs a gradient: the
targets depend on the anchors and the GT only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from omnihd_scenes_tpu_torch.ops.boxes3d import (bbox_overlaps_nearest_3d,
                                                 encode_boxes)


class AnchorTargets(NamedTuple):
    """Per-anchor training targets, (B, A) or (B, A, 9)."""

    labels: torch.Tensor         # int32 class id; num_classes = background
    label_weights: torch.Tensor  # 1 for pos + neg, 0 for ignored
    bbox_targets: torch.Tensor   # encoded deltas (B, A, 9)
    bbox_weights: torch.Tensor   # 1 for pos anchors
    dir_targets: torch.Tensor    # int32 direction bin (0 / 1)
    num_pos: torch.Tensor        # (B,) int32


@torch.no_grad()
def assign_targets(anchors, gt_boxes, gt_labels, gt_mask, num_classes: int,
                   pos_iou_thr: float = 0.6, neg_iou_thr: float = 0.3,
                   min_pos_iou: float = 0.3,
                   dir_offset: float = 0.7854) -> AnchorTargets:
    """anchors (A, 9); gt_boxes (B, G, 9), gt_labels (B, G) int, gt_mask
    (B, G) bool."""
    g = gt_boxes.shape[1]
    iou = bbox_overlaps_nearest_3d(gt_boxes, anchors)          # (B, G, A)
    iou = torch.where(gt_mask[..., None], iou, -1.0)

    anchor_max = iou.amax(1)                                   # (B, A)
    anchor_arg = iou.argmax(1)
    pos, neg = anchor_max >= pos_iou_thr, anchor_max < neg_iou_thr

    # GT-forcing: each valid GT claims the anchors at its max IoU (if >=
    # min_pos_iou); the last claiming GT wins, like the reference's loop.
    gt_max = iou.amax(2, keepdim=True)                         # (B, G, 1)
    claims = (iou == gt_max) & (gt_max >= min_pos_iou) & gt_mask[..., None]
    claimed = claims.any(1)
    gt_index = torch.arange(g, device=iou.device)[:, None]
    claim_gt = torch.where(claims, gt_index, -1).argmax(1)

    assigned = torch.where(claimed, claim_gt,
                           torch.where(pos, anchor_arg, 0))
    is_pos = claimed | pos
    is_neg = neg & ~claimed
    label_weights = (is_pos | is_neg).float()
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, assigned),
                         num_classes).to(torch.int32)

    matched = torch.gather(gt_boxes, 1, assigned[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))                           # (B, A, 9)
    bbox_targets = torch.where(is_pos[..., None],
                               encode_boxes(anchors, matched), 0.0)
    # Direction bin: floor((gt_yaw - dir_offset) / pi) mod 2.
    rot = matched[..., 6] - dir_offset
    dir_targets = torch.floor(rot * (1.0 / math.pi)).to(torch.int32) % 2
    dir_targets = torch.where(is_pos, dir_targets, 0).to(torch.int32)
    return AnchorTargets(labels, label_weights, bbox_targets, is_pos.float(),
                         dir_targets, is_pos.sum(1, dtype=torch.int32))
