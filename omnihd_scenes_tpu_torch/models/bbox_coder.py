"""DETR-style 10-dim box codes and NMS-free decoding (counterpart of
``omnihd_scenes_tpu/models/bbox_coder.py``).

- :func:`normalize_bbox` / :func:`denormalize_bbox` (reference
  ``core/bbox/util.py:4-54``): code = (cx, cy, log w, log l, cz, log h,
  sin r, cos r, vx, vy); boxes are gravity-centred in the code space and
  bottom-centred outside.
- :func:`nms_free_decode` (reference ``NMSFreeCoder``,
  ``core/bbox/coders/nms_free_coder.py:10-124``): sigmoid scores, a flat
  top-k over (query x class), denormalize, the post-centre-range mask and
  the optional score threshold.

Every function takes a leading batch dimension where JAX decodes one
sample (and vmaps).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class NMSFreeCoderCfg(NamedTuple):
    post_center_range: Sequence[float] = (-70, -50, -10.0, 70, 50, 10.0)
    max_num: int = 300
    num_classes: int = 4
    score_threshold: float = None


def normalize_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) [x, y, z_bottom, w, l, h, yaw, vx, vy] -> (..., 10) code."""
    cx, cy, z, w, l, h, rot, vx, vy = boxes.unbind(-1)
    return torch.stack([cx, cy, w.log(), l.log(), z + h * 0.5, h.log(),
                        rot.sin(), rot.cos(), vx, vy], -1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """(..., 10) code -> (..., 9) box (bottom-centred z)."""
    cx, cy, w_log, l_log, cz, h_log, rot_s, rot_c, vx, vy = code.unbind(-1)
    h = h_log.exp()
    return torch.stack([cx, cy, cz - h * 0.5, w_log.exp(), l_log.exp(), h,
                        torch.atan2(rot_s, rot_c), vx, vy], -1)


def nms_free_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                    cfg: NMSFreeCoderCfg = NMSFreeCoderCfg()):
    """Decode the final decoder layer's outputs.

    cls_scores (B, num_query, num_classes) logits; bbox_preds (B,
    num_query, 10) codes.  Returns boxes (B, max_num, 9), scores (B,
    max_num), labels (B, max_num) int32 and valid (B, max_num) bool, all
    on the inputs' device.
    """
    scores = cls_scores.sigmoid()
    b, nq, nc = scores.shape
    k = min(cfg.max_num, nq * nc)
    top_scores, top_idx = scores.reshape(b, -1).topk(k, dim=-1)
    labels = (top_idx % nc).to(torch.int32)
    query_idx = top_idx // nc
    boxes = denormalize_bbox(torch.gather(
        bbox_preds, 1, query_idx[..., None].expand(-1, -1,
                                                   bbox_preds.shape[-1])))
    center = (boxes[..., 0], boxes[..., 1],
              boxes[..., 2] + boxes[..., 5] * 0.5)          # gravity z
    lo, hi = cfg.post_center_range[:3], cfg.post_center_range[3:]
    # Python bounds: no host-to-device copy, so the host never waits.
    valid = torch.ones_like(top_scores, dtype=torch.bool)
    for c, a, z in zip(center, lo, hi):
        valid = valid & (c >= a) & (c <= z)
    if cfg.score_threshold is not None:
        valid = valid & (top_scores > cfg.score_threshold)
    if k < cfg.max_num:
        pad = cfg.max_num - k
        boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 9)], 1)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(b, pad)], 1)
        labels = torch.cat([labels, labels.new_zeros(b, pad)], 1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], 1)
    return boxes, top_scores, labels, valid
