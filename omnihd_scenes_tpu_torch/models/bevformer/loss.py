"""BEVFormer's Hungarian-matched DETR loss (counterpart of
``DETRLossCfg`` / ``bevformer_head_loss`` in
``omnihd_scenes_tpu/models/bevformer/head.py``; reference
``BEVFormerHead.loss``, ``dense_heads/bevformer_head.py``).

Per decoder layer: the queries are matched to the padded GTs
(:func:`models.hungarian.hungarian_match`, all samples and layers in one
host round trip), then the focal loss over every query against the
matched labels (background elsewhere) and the code-weighted L1 loss over
the matched queries, each over ``num_pos`` clipped to at least 1 and
scaled by ``cls_weight`` / ``bbox_weight``.

The labels and box targets are written as the JAX package writes them:
every GT slot writes to ``where(matched >= 0, matched, 0)``, a padded
slot the background label and a zero target, and where several slots
target one query the highest slot wins (XLA's last write).  So when a
real GT is matched to query 0 and padded slots follow it, query 0 keeps
its positive mask but gets the background label and a zero target, where
upstream labels only the matched queries (ROADMAP queue 3 item 14,
mirrored).  The winner is resolved explicitly, a ``scatter_reduce``
(amax) of the slot index, so the result is the same on the CPU and on
the card.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from omnihd_scenes_tpu_torch.models.bbox_coder import normalize_bbox
from omnihd_scenes_tpu_torch.models.hungarian import hungarian_match
from omnihd_scenes_tpu_torch.models.losses import sigmoid_focal_loss


class DETRLossCfg(NamedTuple):
    num_classes: int = 4
    cls_weight: float = 2.0
    bbox_weight: float = 0.25
    code_weights: Sequence[float] = (1.0,) * 8 + (0.2, 0.2)


@functools.lru_cache(maxsize=None)
def _code_weights(weights: Tuple[float, ...], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The code weights on ``device``, made once per device and dtype: a
    copy from host memory in every step would make the host wait for the
    card."""
    with torch.inference_mode(False):
        return torch.tensor(weights, dtype=dtype, device=device)


def assign_targets(matched: torch.Tensor, gt_labels: torch.Tensor,
                   gt_codes: torch.Tensor, gt_mask: torch.Tensor,
                   num_query: int, num_classes: int):
    """Per-query labels (..., nq) and box targets (..., nq, D) from the
    matches (..., G) and the GTs (..., G) / (..., G, D), as the JAX
    package's scatters with repeated indices leave them: the highest GT
    slot that writes a query wins."""
    safe_q = torch.where(matched >= 0, matched, torch.zeros_like(matched))
    slots = torch.arange(matched.shape[-1], device=matched.device).expand_as(
        matched)
    winner = torch.full((*matched.shape[:-1], num_query), -1,
                        dtype=torch.long, device=matched.device)
    winner = winner.scatter_reduce(-1, safe_q, slots, 'amax')
    written = winner >= 0
    src = winner.clamp(min=0)
    slot_labels = torch.where(gt_mask, gt_labels.long(),
                              torch.full_like(gt_labels, num_classes).long())
    slot_codes = torch.where(gt_mask[..., None], gt_codes,
                             torch.zeros_like(gt_codes))
    labels = torch.where(written, torch.gather(slot_labels, -1, src),
                         torch.full_like(src, num_classes))
    targets = torch.gather(slot_codes, -2, src[..., None].expand(
        *src.shape, gt_codes.shape[-1]))
    targets = torch.where(written[..., None], targets,
                          torch.zeros_like(targets))
    return labels, targets


def bevformer_head_loss(all_cls_scores: torch.Tensor,
                        all_bbox_preds: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        gt_mask: torch.Tensor,
                        cfg: DETRLossCfg = DETRLossCfg()
                        ) -> Dict[str, torch.Tensor]:
    """The loss of B samples over all decoder layers.

    all_cls_scores (B, L, nq, num_classes) logits; all_bbox_preds (B, L,
    nq, 10) codes; gt_boxes (B, G, 9) padded [x, y, z_bottom, w, l, h,
    yaw, vx, vy]; gt_labels (B, G); gt_mask (B, G) bool.

    Returns per-sample (B,) values: ``d{l}.loss_cls`` / ``d{l}.loss_bbox``
    for every layer, ``loss_cls`` / ``loss_bbox`` of the last layer and
    ``total``, the sum over layers of both.
    """
    b, num_layers, nq, _ = all_cls_scores.shape
    # GT boxes arrive in bf16 under the bf16 policy: coded in the
    # outputs' (upcast) dtype.
    gt_codes = normalize_bbox(gt_boxes.to(torch.promote_types(
        gt_boxes.dtype, all_bbox_preds.dtype)))          # (B, G, 10)
    code_w = _code_weights(tuple(cfg.code_weights), all_bbox_preds.dtype,
                           all_bbox_preds.device)

    def per_layer(t):
        return t[:, None].expand(b, num_layers, *t.shape[1:])

    matched, pos_mask = hungarian_match(
        all_cls_scores, all_bbox_preds, per_layer(gt_codes),
        per_layer(gt_labels), per_layer(gt_mask), cfg.cls_weight,
        cfg.bbox_weight)
    labels, targets = assign_targets(
        matched, per_layer(gt_labels), per_layer(gt_codes),
        per_layer(gt_mask), nq, cfg.num_classes)
    num_pos = pos_mask.sum(-1).clamp(min=1).to(all_cls_scores.dtype)
    one_hot = F.one_hot(labels, cfg.num_classes + 1)[..., :-1].to(
        all_cls_scores.dtype)
    cls_loss = sigmoid_focal_loss(all_cls_scores, one_hot).sum((-2, -1)) \
        / num_pos
    l1 = (all_bbox_preds - targets).abs() * code_w
    l1 = torch.where(torch.isfinite(targets), l1, torch.zeros_like(l1))
    bbox_loss = (l1 * pos_mask[..., None]).sum((-2, -1)) / num_pos
    cls_loss = cfg.cls_weight * cls_loss                 # (B, L)
    bbox_loss = cfg.bbox_weight * bbox_loss
    losses = {}
    for lvl in range(num_layers):
        losses[f'd{lvl}.loss_cls'] = cls_loss[:, lvl]
        losses[f'd{lvl}.loss_bbox'] = bbox_loss[:, lvl]
    losses['loss_cls'] = cls_loss[:, -1]
    losses['loss_bbox'] = bbox_loss[:, -1]
    losses['total'] = cls_loss.sum(1) + bbox_loss.sum(1)
    return losses
