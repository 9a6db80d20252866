"""Anchor3DHead and box decoding (counterpart of
``omnihd_scenes_tpu/models/anchor_head.py``).

The decode functions take the JAX layouts — head maps (..., H, W, A*K),
anchors (H, W, A, 9) — with optional leading batch dims.  The JAX
``blocked_top_k`` and its wide-row gather exist to dodge the TPU's
narrow-gather cost; here the pre-NMS top-k is ``torch.topk`` and the rows
are read with a direct index.  ``torch.topk`` breaks ties differently
from ``blocked_top_k``, so tests compare :func:`decode_at` at the JAX
package's indices.

:func:`anchor_head_loss` is the training loss, batched: each sample's
loss normalised by its own positive count, then the batch mean, which is
what the JAX package's ``vmap`` of ``anchor_head_loss`` + ``mean`` gives
(``train/builder.py:165-170``).  It runs in f32 whatever the head's
dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Sequence

import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import DecodeCfg
from omnihd_scenes_tpu_torch.models.losses import (sigmoid_focal_loss,
                                                   smooth_l1,
                                                   softmax_cross_entropy)
from omnihd_scenes_tpu_torch.models.target_assign import assign_targets
from omnihd_scenes_tpu_torch.ops.boxes3d import decode_boxes, limit_period
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.utils.timing import span


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

    def outputs(self, bev):
        """(B, C, H, W) BEV -> the JAX-layout dict: 'cls_score' /
        'bbox_pred' / 'dir_pred' (B, H, W, A*K) and 'bev' (B, H, W, C),
        NHWC views."""
        names = ('cls_score', 'bbox_pred', 'dir_pred', 'bev')
        return {k: t.permute(0, 2, 3, 1)
                for k, t in zip(names, (*self(bev), bev))}


class HeadLossConfig(NamedTuple):
    num_classes: int = 4
    code_weights: Sequence[float] = (1.0,) * 7 + (0.2, 0.2)
    dir_offset: float = 0.7854
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    cls_weight: float = 1.0
    bbox_weight: float = 1.0
    dir_weight: float = 0.2


def _add_sin_difference(pred_rot, target_rot):
    """(sin(a) cos(b), cos(a) sin(b)): L1 on their difference is L1 on
    sin(a - b) (mmdet3d ``add_sin_difference``)."""
    return (torch.sin(pred_rot) * torch.cos(target_rot),
            torch.cos(pred_rot) * torch.sin(target_rot))


@functools.lru_cache(maxsize=8)
def _code_weights(weights, device):
    """The code weights on ``device``, uploaded once."""
    return torch.tensor(weights, dtype=torch.float32, device=device)


def anchor_head_loss(cls_score, bbox_pred, dir_pred, anchors, gt_boxes,
                     gt_labels, gt_mask,
                     cfg: HeadLossConfig = HeadLossConfig()
                     ) -> Dict[str, torch.Tensor]:
    """Batch-mean anchor head losses.

    cls_score (B, H, W, A*C), bbox_pred (B, H, W, A*9), dir_pred (B, H, W,
    A*2), anchors (H, W, A, 9) shared by the batch, gt_boxes (B, G, 9),
    gt_labels (B, G), gt_mask (B, G).  Returns 'loss_cls', 'loss_bbox',
    'loss_dir' and 'num_pos' (the batch mean of each sample's count).
    The terms are evaluated in the predictions' dtype, promoted with the
    f32 targets as ``jnp`` promotes them (the JAX loss under its bf16
    policy); ``train/builder.py:DetectionLosses`` picks that dtype.
    """
    b, nc = cls_score.shape[0], cfg.num_classes
    flat_anchors = anchors.reshape(-1, anchors.shape[-1]).float()
    a, code = flat_anchors.shape
    cls_score = cls_score.reshape(b, a, nc)
    bbox_pred = bbox_pred.reshape(b, a, code)
    dir_pred = dir_pred.reshape(b, a, 2)

    tgt = assign_targets(flat_anchors, gt_boxes.float(), gt_labels, gt_mask,
                         nc, cfg.pos_iou_thr, cfg.neg_iou_thr,
                         cfg.min_pos_iou, cfg.dir_offset)
    num_pos = tgt.num_pos.float().clamp(min=1.0)                # (B,)

    # Classification: one-hot with an all-zero background row (a compare:
    # F.one_hot checks its range on the host, which waits for the card).
    one_hot = (tgt.labels[..., None] == torch.arange(
        nc, device=tgt.labels.device)).float()
    cls_loss = sigmoid_focal_loss(cls_score, one_hot)
    cls_loss = (cls_loss * tgt.label_weights[..., None]).sum((1, 2)) / num_pos

    # Regression with the sin-difference yaw.
    pred_rot, tgt_rot = _add_sin_difference(bbox_pred[..., 6],
                                            tgt.bbox_targets[..., 6])
    pred = torch.cat([bbox_pred[..., :6], pred_rot[..., None],
                      bbox_pred[..., 7:]], -1)
    target = torch.cat([tgt.bbox_targets[..., :6], tgt_rot[..., None],
                        tgt.bbox_targets[..., 7:]], -1)
    code_w = _code_weights(tuple(cfg.code_weights), pred.device)
    reg_loss = smooth_l1(pred, target) * code_w
    reg_loss = (reg_loss * tgt.bbox_weights[..., None]).sum((1, 2)) / num_pos

    # Direction classification on the positive anchors.
    dir_loss = softmax_cross_entropy(dir_pred, tgt.dir_targets)
    dir_loss = (dir_loss * tgt.bbox_weights).sum(1) / num_pos

    return {'loss_cls': (cfg.cls_weight * cls_loss).mean(),
            'loss_bbox': (cfg.bbox_weight * reg_loss).mean(),
            'loss_dir': (cfg.dir_weight * dir_loss).mean(),
            'num_pos': tgt.num_pos.float().mean()}


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
    validity (decode, the span ``decode.candidates``, + rotated NMS)."""
    with span('decode.candidates'):
        boxes, scores = anchor_head_decode_candidates(
            cls_score, bbox_pred, dir_pred, anchors, cfg)
    return multiclass_nms_rotated(boxes, scores, cfg.score_thr, cfg.nms_thr,
                                  cfg.max_num)
