"""CenterPoint-style detection head (counterpart of
``omnihd_scenes_tpu/models/centerpoint_head.py``; reference
``CenterHeadv1``, ``bevfusion/dense_heads/det_centerpoint_head.py:18-627``):
per-class heatmaps with Gaussian targets plus dense regression maps (xy
offset, z, log dims, sin/cos yaw, velocity); the Gaussian focal heatmap
loss + masked L1 regression; decode = 3x3 local-max peak picking + top-k.

Every function takes a batch: maps are (B, C, H, W), padded GT (B, G, .),
and each sample's result is the JAX package's one-sample function's
result on that sample.  Decode takes ``torch.topk`` where JAX takes
``blocked_top_k`` (its TPU workaround, the same values), and
``F.max_pool2d`` pads with -inf as flax's ``'SAME'`` max pool does.

The grid cell of a GT centre, ``int((x - x0) / sx)``, is taken with a
true division on every device: the cell sizes are divided as tensors on
the boxes' device (a CUDA division by a Python scalar is a multiply by
its reciprocal, which can put a centre on a cell boundary one cell over),
which is what the JAX function computes eagerly; jitted, XLA multiplies
by ``f32(1 / sx)`` instead.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU

# The regression maps in the order they are concatenated, with widths.
REG_BRANCHES = (('reg', 2), ('height', 1), ('dim', 3), ('rot', 2),
                ('vel', 2))
HEATMAP_BIAS = -2.19
# ``build_center_targets`` one-hot codes labels over 4 classes whatever the
# head's ``num_classes`` (the JAX function's ``num_classes = int(4)``).
TARGET_CLASSES = 4


class CenterHead(nn.Module):
    """Shared ConvBNReLU trunk + one ConvBNReLU -> 1x1 conv branch per
    output map, over the (B, C_in, H, W) BEV."""

    def __init__(self, in_channels: int, num_classes: int = 4,
                 share_channels: int = 64, head_channels: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.shared = ConvBNReLU(in_channels, share_channels, 3)
        self.branches = (('heatmap', num_classes),) + REG_BRANCHES
        for name, out_ch in self.branches:
            setattr(self, f'{name}_conv',
                    ConvBNReLU(share_channels, head_channels, 3))
            out = nn.Conv2d(head_channels, out_ch, 1)
            nn.init.constant_(out.bias, HEATMAP_BIAS if name == 'heatmap'
                              else 0.0)
            setattr(self, f'{name}_out', out)

    def forward(self, bev) -> Dict[str, torch.Tensor]:
        x = self.shared(bev)
        return {name: getattr(self, f'{name}_out')(
                    getattr(self, f'{name}_conv')(x))
                for name, _ in self.branches}


class CenterTargetCfg(NamedTuple):
    pc_range: Sequence[float] = (-60, -40, -3.0, 60, 40, 5.0)
    out_hw: Tuple[int, int] = (160, 240)     # (H=y, W=x)
    min_radius: int = 2
    gaussian_overlap: float = 0.1


def _cell_sizes(cfg: CenterTargetCfg):
    h, w = cfg.out_hw
    pc = cfg.pc_range
    return (pc[3] - pc[0]) / w, (pc[4] - pc[1]) / h


def gaussian_radius(l_pix, w_pix, min_overlap: float = 0.1):
    """CenterNet radius (reference ``utils/gaussian.py:62-88``)."""
    height, width = l_pix, w_pix
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * a1 * c1).clamp(min=0))) / 2
    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * a2 * c2).clamp(min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def build_center_targets(gt_boxes, gt_labels, gt_mask,
                         cfg: CenterTargetCfg = CenterTargetCfg()):
    """Padded GT (B, G, 9) / (B, G) / (B, G) -> 'heatmap' (B, 4, H, W),
    'targets' (B, G, 10), grid indices 'gy' / 'gx' (B, G) int64 and
    'valid' (B, G) bool.  The heatmap has ``TARGET_CLASSES`` (4) channels
    whatever the head's class count, as in JAX; labels outside [0, 4)
    splat nothing."""
    h, w = cfg.out_hw
    pc = cfg.pc_range
    sx, sy = (torch.full((), s, dtype=gt_boxes.dtype, device=gt_boxes.device)
              for s in _cell_sizes(cfg))
    cx = (gt_boxes[..., 0] - pc[0]) / sx
    cy = (gt_boxes[..., 1] - pc[1]) / sy
    in_grid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & gt_mask.bool()
    # JAX's astype(int32) truncates towards zero, as .long() does.
    gx = cx.long().clamp(0, w - 1)
    gy = cy.long().clamp(0, h - 1)

    l_pix = gt_boxes[..., 4] / sy
    w_pix = gt_boxes[..., 3] / sx
    radius = gaussian_radius(l_pix, w_pix, cfg.gaussian_overlap).clamp(
        min=cfg.min_radius)

    ys = torch.arange(h, dtype=gt_boxes.dtype, device=gt_boxes.device)
    xs = torch.arange(w, dtype=gt_boxes.dtype, device=gt_boxes.device)
    g = torch.exp(-(((ys[:, None] - cy[..., None, None]) ** 2
                     + (xs - cx[..., None, None]) ** 2)
                    / (2 * (radius[..., None, None] / 3) ** 2)))
    g = torch.where(in_grid[..., None, None], g, 0.0)      # (B, G, H, W)
    classes = torch.arange(TARGET_CLASSES, device=gt_labels.device)
    onehot = (gt_labels[..., None] == classes).to(g.dtype)   # (B, G, 4)
    heatmap = torch.einsum('bghw,bgc->bchw', g, onehot).clamp(0.0, 1.0)

    targets = torch.stack([
        cx - gx, cy - gy,                                   # sub-pixel
        gt_boxes[..., 2] + gt_boxes[..., 5] * 0.5,          # gravity z
        torch.log(gt_boxes[..., 3].clamp(min=1e-3)),
        torch.log(gt_boxes[..., 4].clamp(min=1e-3)),
        torch.log(gt_boxes[..., 5].clamp(min=1e-3)),
        torch.sin(gt_boxes[..., 6]), torch.cos(gt_boxes[..., 6]),
        gt_boxes[..., 7], gt_boxes[..., 8]], -1)
    return {'heatmap': heatmap, 'targets': targets, 'gy': gy, 'gx': gx,
            'valid': in_grid}


def gaussian_focal_loss(pred_logits, gt, alpha: float = 2.0,
                        gamma: float = 4.0):
    """CenterNet penalty-reduced focal loss of each sample (B,),
    normalised by its peaks."""
    p = torch.sigmoid(pred_logits)
    eps = 1e-6
    pos = (gt >= 1.0 - 1e-4).to(p.dtype)
    neg_w = (1 - gt) ** gamma
    pos_loss = -torch.log(p + eps) * (1 - p) ** alpha * pos
    neg_loss = -torch.log(1 - p + eps) * p ** alpha * neg_w * (1 - pos)
    dims = tuple(range(1, p.dim()))
    n_pos = pos.sum(dims).clamp(min=1.0)
    return (pos_loss.sum(dims) + neg_loss.sum(dims)) / n_pos


def _filled(values: Sequence[float], like) -> torch.Tensor:
    """``values`` as a 1-d tensor on ``like``'s device, made by fills: a
    copy from the host would make it wait for the card."""
    out = torch.full((len(values),), values[0], dtype=like.dtype,
                     device=like.device)
    for i, v in enumerate(values):
        if v != values[0]:
            out[i:i + 1].fill_(v)
    return out


def _reg_map(preds):
    """(B, 10, H, W): the regression maps in target order."""
    return torch.cat([preds[name] for name, _ in REG_BRANCHES], 1)


def _gather_cells(maps, gy, gx):
    """maps (B, K, H, W) at the cells (gy, gx) (B, N) -> (B, N, K)."""
    b, k, _, w = maps.shape
    idx = (gy * w + gx)[:, None, :].expand(b, k, -1)
    return torch.gather(maps.flatten(2), 2, idx).transpose(1, 2)


def center_head_loss(preds: Dict[str, torch.Tensor], gt_boxes, gt_labels,
                     gt_mask, cfg: CenterTargetCfg = CenterTargetCfg(),
                     code_weights=(1.0,) * 8 + (0.2, 0.2)):
    """Each sample's CenterPoint loss: 'loss_heatmap' (focal) and
    'loss_bbox' (L1 of the regression maps at the GT cells), each (B,);
    their batch mean is the batch's loss."""
    tgt = build_center_targets(gt_boxes, gt_labels, gt_mask, cfg)
    hm_loss = gaussian_focal_loss(preds['heatmap'], tgt['heatmap'])
    picked = _gather_cells(_reg_map(preds), tgt['gy'], tgt['gx'])
    l1 = (picked - tgt['targets']).abs() * _filled(code_weights, picked)
    valid = tgt['valid']
    n = valid.sum(1).clamp(min=1)
    reg_loss = (l1 * valid[..., None]).sum((1, 2)) / n
    return {'loss_heatmap': hm_loss, 'loss_bbox': reg_loss}


def center_head_decode(preds: Dict[str, torch.Tensor],
                       cfg: CenterTargetCfg = CenterTargetCfg(),
                       max_num: int = 500, score_thr: float = 0.1):
    """Peak-picking decode (3x3 local max + top-k over cells and classes,
    in JAX's (y, x, class) order) -> boxes (B, max_num, 9) [x, y,
    z_bottom, w, l, h, yaw, vx, vy], scores (B, max_num), classes (B,
    max_num) int64 and valid (B, max_num) (score above ``score_thr``);
    padded with zeros where the map has fewer than ``max_num`` entries."""
    h, w = cfg.out_hw
    pc = cfg.pc_range
    sx, sy = _cell_sizes(cfg)

    heat = torch.sigmoid(preds['heatmap'])                  # (B, C, H, W)
    localmax = F.max_pool2d(heat, 3, stride=1, padding=1)
    heat = torch.where(heat >= localmax, heat, 0.0)

    b, c = heat.shape[:2]
    flat = heat.permute(0, 2, 3, 1).reshape(b, -1)
    k = min(max_num, flat.shape[1])
    scores, idx = torch.topk(flat, k)
    cls = idx % c
    pix = idx // c
    gy, gx = pix // w, pix % w

    r = _gather_cells(_reg_map(preds), gy, gx)              # (B, k, 10)
    x = (gx.to(r.dtype) + r[..., 0]) * sx + pc[0]
    y = (gy.to(r.dtype) + r[..., 1]) * sy + pc[1]
    dims = torch.exp(r[..., 3:6])
    yaw = torch.atan2(r[..., 6], r[..., 7])
    z_bottom = r[..., 2] - dims[..., 2] * 0.5
    boxes = torch.stack([x, y, z_bottom, dims[..., 0], dims[..., 1],
                         dims[..., 2], yaw, r[..., 8], r[..., 9]], -1)
    valid = scores > score_thr
    if k < max_num:
        boxes, scores, cls, valid = (
            torch.cat([t, t.new_zeros((b, max_num - k) + t.shape[2:])], 1)
            for t in (boxes, scores, cls, valid))
    return boxes, scores, cls, valid
