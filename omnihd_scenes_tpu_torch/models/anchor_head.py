"""Anchor3DHead and box decoding (counterpart of
``omnihd_scenes_tpu/models/anchor_head.py``).

The decode functions take the JAX layouts — head maps (..., H, W, A*K),
anchors (H, W, A, 9) — with optional leading batch dims.  The JAX
``blocked_top_k`` and its wide-row gather exist to dodge the TPU's
narrow-gather cost; here the pre-NMS top-k is ``torch.topk`` and the rows
are read with a direct index.  ``torch.topk`` breaks ties differently
from ``blocked_top_k``, so tests compare :func:`decode_at` at the JAX
package's indices.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import DecodeCfg
from omnihd_scenes_tpu_torch.ops.boxes3d import decode_boxes, limit_period
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated


class Anchor3DHead(nn.Module):
    """1x1 classification / regression / direction convs."""

    def __init__(self, in_channels: int, num_classes: int = 4,
                 num_anchors: int = 8, code_size: int = 9):
        super().__init__()
        self.conv_cls = nn.Conv2d(in_channels, num_anchors * num_classes, 1)
        self.conv_reg = nn.Conv2d(in_channels, num_anchors * code_size, 1)
        self.conv_dir = nn.Conv2d(in_channels, num_anchors * 2, 1)

    def forward(self, x):
        return self.conv_cls(x), self.conv_reg(x), self.conv_dir(x)


def _rows(table, idx):
    """table (..., A, K), idx (..., k) -> (..., k, K)."""
    return torch.gather(table, -2,
                        idx[..., None].expand(*idx.shape, table.shape[-1]))


def decode_at(cls_score, bbox_pred, dir_pred, anchors, idx,
              cfg: DecodeCfg = DecodeCfg()):
    """Decode the anchors at flat indices ``idx`` (..., k): (..., k, 9)
    boxes with the direction bin folded into yaw, (..., k, C) sigmoid
    scores."""
    code_size, aa = anchors.shape[-1], anchors.shape[-2]
    lead = cls_score.shape[:-3]
    a = anchors.numel() // code_size
    num_classes = cls_score.shape[-1] // aa
    bb = _rows(bbox_pred.reshape(*lead, a, code_size), idx)
    dp = _rows(dir_pred.reshape(*lead, a, 2), idx)
    lg = _rows(cls_score.reshape(*lead, a, num_classes), idx)
    an = anchors.reshape(a, code_size)[idx]
    boxes = decode_boxes(an, bb)
    dir_bin = dp.argmax(-1).to(boxes.dtype)
    dir_rot = limit_period(boxes[..., 6] - cfg.dir_offset,
                           cfg.dir_limit_offset, math.pi)
    yaw = dir_rot + cfg.dir_offset + math.pi * dir_bin
    boxes = torch.cat([boxes[..., :6], yaw[..., None], boxes[..., 7:]], -1)
    return boxes, torch.sigmoid(lg)


def anchor_head_decode_candidates(cls_score, bbox_pred, dir_pred, anchors,
                                  cfg: DecodeCfg = DecodeCfg()):
    """The top ``nms_pre`` anchors by max class score, decoded.

    The key is ``sigmoid(max logit)``, as in JAX (bit-identical keys to
    the max of the sigmoids, so only tie order can differ).
    """
    aa = anchors.shape[-2]
    lead = cls_score.shape[:-3]
    a = anchors.numel() // anchors.shape[-1]
    logits = cls_score.reshape(*lead, a, cls_score.shape[-1] // aa)
    key = torch.sigmoid(logits.amax(-1))
    idx = torch.topk(key, min(cfg.nms_pre, a), dim=-1).indices
    return decode_at(cls_score, bbox_pred, dir_pred, anchors, idx, cfg)


def anchor_head_get_bboxes(cls_score, bbox_pred, dir_pred, anchors,
                           cfg: DecodeCfg = DecodeCfg()):
    """Head outputs -> padded (..., max_num, 9) boxes, scores, labels and
    validity (decode + rotated NMS)."""
    boxes, scores = anchor_head_decode_candidates(
        cls_score, bbox_pred, dir_pred, anchors, cfg)
    return multiclass_nms_rotated(boxes, scores, cfg.score_thr, cfg.nms_thr,
                                  cfg.max_num)
