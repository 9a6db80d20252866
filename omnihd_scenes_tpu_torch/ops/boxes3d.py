"""3D box geometry (counterpart of ``omnihd_scenes_tpu/ops/boxes3d.py``).

Box layout ``[x, y, z_bottom, w(x_size), l(y_size), h(z_size), yaw, vx,
vy]`` in the LiDAR frame.  Every function takes optional leading batch
dims.  Rotated IoU uses the JAX package's Green's-theorem clipping, op
for op, so keep-sets of the NMS built on it agree.  The nearest-BEV IoU
and the box encoder are the target assigner's (training).

A division by a constant is written as a multiply by its reciprocal
where it feeds ``floor``: that is what the JAX functions compute under
``jax.jit`` (XLA turns ``x / c`` into ``x * (1 / c)``), and every JAX path
that calls them is jitted.
"""

from __future__ import annotations

import math

import torch


def gravity_center(boxes):
    """(..., 3) gravity centres of bottom-centred boxes."""
    return torch.stack([boxes[..., 0], boxes[..., 1],
                        boxes[..., 2] + boxes[..., 5] * 0.5], dim=-1)


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val * (1.0 / period) + offset) * period


def nearest_bev(boxes):
    """Rotated BEV boxes -> nearest axis-aligned (..., 4) (x1, y1, x2, y2):
    the xy extents swap when the yaw is closer to +-pi/2."""
    rot = limit_period(boxes[..., 6], 0.5, math.pi)
    swap = rot.abs() > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    cx, cy = boxes[..., 0], boxes[..., 1]
    return torch.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2],
                       dim=-1)


def iou_2d(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise IoU (..., N, M) of axis-aligned (..., N, 4) and (..., M,
    4) (x1, y1, x2, y2) boxes."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))[..., :, None]
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))[..., None, :]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1 + area2 - inter).clamp(min=eps)


def bbox_overlaps_nearest_3d(boxes1, boxes2):
    """Nearest-BEV IoU matrix (..., N, M) of 7+-dim boxes (the assigner's
    metric, mmdet3d ``BboxOverlapsNearest3D``)."""
    return iou_2d(nearest_bev(boxes1), nearest_bev(boxes2))


def bev_corners(boxes):
    """(..., 4, 2) BEV polygon corners (counter-clockwise)."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    hw, hl = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    yaw = boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([hw, -hw, -hw, hw], dim=-1)
    ly = torch.stack([hl, hl, -hl, -hl], dim=-1)
    gx = cx[..., None] + lx * cos[..., None] - ly * sin[..., None]
    gy = cy[..., None] + lx * sin[..., None] + ly * cos[..., None]
    return torch.stack([gx, gy], dim=-1)


def _edge_clip_cross(p0, r, boxes, eps_in=1e-5, eps_b=1e-5, eps_par=1e-6):
    """Green's-theorem boundary term of directed edges ``p0 + t*r``
    (t in [0, 1]) clipped to rotated boxes; boundary-coincident pieces
    weigh 1/2 (see the JAX docstring for why)."""
    cx, cy, yaw = boxes[..., 0], boxes[..., 1], boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    dx, dy = p0[..., 0] - cx, p0[..., 1] - cy
    al = torch.stack([cos * dx + sin * dy, -sin * dx + cos * dy], -1)
    rl = torch.stack([cos * r[..., 0] + sin * r[..., 1],
                      -sin * r[..., 0] + cos * r[..., 1]], -1)
    h = torch.stack([boxes[..., 3], boxes[..., 4]], -1) * 0.5

    scale = (1.0 + p0[..., 0].abs() + p0[..., 1].abs()
             + r[..., 0].abs() + r[..., 1].abs())[..., None]
    parallel = rl.abs() < eps_par * scale
    safe_rl = torch.where(parallel, torch.ones_like(rl), rl)
    ta = (-h - eps_in - al) / safe_rl
    tb = (h + eps_in - al) / safe_rl
    inside = al.abs() <= h + eps_in
    big = torch.full_like(al, 1e30)
    tmin = torch.where(parallel, torch.where(inside, -big, big),
                       torch.minimum(ta, tb))
    tmax = torch.where(parallel, torch.where(inside, big, -big),
                       torch.maximum(ta, tb))
    t0 = tmin.amax(-1).clamp(min=0.0)
    t1 = tmax.amin(-1).clamp(max=1.0)
    empty = t1 < t0
    t0 = torch.where(empty, torch.zeros_like(t0), t0)
    t1 = torch.where(empty, torch.zeros_like(t1), t1)

    pa = p0 + t0[..., None] * r
    pb = p0 + t1[..., None] * r
    on_boundary = (parallel & ((al.abs() - h).abs() <= eps_b)).any(-1)
    w = torch.where(on_boundary, 0.5, 1.0).to(pa.dtype)
    return w * (pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0])


def rotated_intersection_bev(boxes1, boxes2):
    """Exact pairwise rotated BEV intersection areas (..., N, M)."""
    c1, c2 = bev_corners(boxes1), bev_corners(boxes2)     # (..., N, 4, 2)
    r1 = c1.roll(-1, dims=-2) - c1                        # CCW edges
    r2 = c2.roll(-1, dims=-2) - c2
    s1 = _edge_clip_cross(c1[..., :, None, :, :], r1[..., :, None, :, :],
                          boxes2[..., None, :, None, :])
    s2 = _edge_clip_cross(c2[..., None, :, :, :], r2[..., None, :, :, :],
                          boxes1[..., :, None, None, :])
    inter = 0.5 * (s1.sum(-1) + s2.sum(-1))
    area1 = (boxes1[..., 3] * boxes1[..., 4])[..., :, None]
    area2 = (boxes2[..., 3] * boxes2[..., 4])[..., None, :]
    return torch.minimum(inter.clamp(min=0.0), torch.minimum(area1, area2))


def rotated_iou_bev(boxes1, boxes2, eps: float = 1e-6):
    """Exact pairwise rotated BEV IoU (..., N, M)."""
    inter = rotated_intersection_bev(boxes1, boxes2)
    area1 = (boxes1[..., 3] * boxes1[..., 4])[..., :, None]
    area2 = (boxes2[..., 3] * boxes2[..., 4])[..., None, :]
    return inter / (area1 + area2 - inter).clamp(min=eps)


def encode_boxes(anchors, gt):
    """Anchor-relative regression targets (mmdet3d
    ``DeltaXYZWLHRBBoxCoder``); anchors and gt (..., 9)."""
    xa, ya, za, wa, la, ha, ra, vxa, vya = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg, vxg, vyg = gt.unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la * la + wa * wa)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                        torch.log(wg / wa), torch.log(lg / la),
                        torch.log(hg / ha), rg - ra, (vxg - vxa) / diag,
                        (vyg - vya) / diag], dim=-1)


def decode_boxes(anchors, deltas):
    """DeltaXYZWLHR decode (code size 9), inverse of the JAX
    ``encode_boxes``."""
    xa, ya, za, wa, la, ha, ra, vxa, vya = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt, vxt, vyt = deltas.unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la * la + wa * wa)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    vxg = vxt * diag + vxa
    vyg = vyt * diag + vya
    return torch.stack([xg, yg, zg, wg, lg, hg, rg, vxg, vyg], dim=-1)
