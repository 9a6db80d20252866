"""Host-side greedy rotated NMS, the host half of ``tools.test
--host-nms`` (counterpart of ``omnihd_scenes_tpu/ops/nms_host.py``).

With ``host_nms`` the device work of an anchor-family predict ends at the
top-``nms_pre`` candidate decode (``models/anchor_head.py:
anchor_head_decode_candidates``); the candidates come back to the host in
one copy and the O(N^2) suppression runs here, in the native C++ core
(``csrc/host_ops.cpp:nms_rotated_multiclass``, built by ``data/
native.py``; ctypes releases the interpreter lock around it).  Semantics
are those of the in-graph ``ops/nms.py:multiclass_nms_rotated``: greedy
per class by descending score, suppress rotated-BEV IoU > thr, survivors
merged in flat class-major top-k order, the top ``max_num`` kept.  The
kept rows equal the in-graph path's as multisets but where a pair's IoU
sits within float tolerance of the threshold (``tests/
test_torch_port_nms_host.py``).

:func:`nms_rotated_multiclass_plain` is JAX's ``_nms_numpy``, the plain
form the tests use; :func:`rotated_iou_matrix_plain` is its IoU for all
pairs at once, in f64 PyTorch on any device, for candidate sets too large
for the plain form's Python loop, and :func:`greedy_kept` the greedy
pass over such a matrix.  Unlike the JAX package, a missing library is an
error, not a quiet switch to NumPy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from omnihd_scenes_tpu_torch.data.native import get_lib


def _rotated_iou_np(b1: np.ndarray, b2: np.ndarray) -> float:
    """Exact rotated-BEV IoU of two boxes, by polygon clipping in f64."""
    a1 = float(b1[3]) * float(b1[4])
    a2 = float(b2[3]) * float(b2[4])
    if a1 <= 0 or a2 <= 0:
        return 0.0
    dx, dy = float(b1[0] - b2[0]), float(b1[1] - b2[1])
    r1 = 0.5 * float(np.hypot(b1[3], b1[4]))
    r2 = 0.5 * float(np.hypot(b2[3], b2[4]))
    if dx * dx + dy * dy > (r1 + r2) ** 2:
        return 0.0

    c, s = np.cos(float(b1[6])), np.sin(float(b1[6]))
    hw, hl = 0.5 * float(b1[3]), 0.5 * float(b1[4])
    lx = np.array([hw, -hw, -hw, hw])
    ly = np.array([hl, hl, -hl, -hl])
    poly = np.stack([b1[0] + lx * c - ly * s,
                     b1[1] + lx * s + ly * c], axis=-1)

    c2, s2 = np.cos(float(b2[6])), np.sin(float(b2[6]))
    cx, cy = float(b2[0]), float(b2[1])
    hw2, hl2 = 0.5 * float(b2[3]), 0.5 * float(b2[4])
    planes = [(c2, s2, hw2 + c2 * cx + s2 * cy),
              (-c2, -s2, hw2 - c2 * cx - s2 * cy),
              (-s2, c2, hl2 - s2 * cx + c2 * cy),
              (s2, -c2, hl2 + s2 * cx - c2 * cy)]
    for nx, ny, cc in planes:
        if len(poly) < 3:
            return 0.0
        out = []
        d = poly @ np.array([nx, ny]) - cc
        for i in range(len(poly)):
            j = (i + 1) % len(poly)
            if d[i] <= 0:
                out.append(poly[i])
            if (d[i] < 0 < d[j]) or (d[j] < 0 < d[i]):
                t = d[i] / (d[i] - d[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        poly = np.asarray(out) if out else np.zeros((0, 2))
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    inter = 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
    inter = min(max(inter, 0.0), a1, a2)
    return inter / (a1 + a2 - inter)


def _clip_halfplane(poly, cnt, nx, ny, c):
    """One Sutherland-Hodgman step of :func:`_rotated_iou_np` for a batch
    of convex polygons (P, K, 2) with ``cnt`` vertices each: keep the
    part with n . p <= c -> (P, K, 2), counts."""
    p, k = poly.shape[:2]
    i = torch.arange(k, device=poly.device)[None]
    valid = i < cnt[:, None]
    nxt = torch.where(i + 1 < cnt[:, None], i + 1, 0)
    d = poly[..., 0] * nx[:, None] + poly[..., 1] * ny[:, None] - c[:, None]
    dj = d.gather(1, nxt)
    pj = poly.gather(1, nxt[..., None].expand(-1, -1, 2))
    keep = valid & (d <= 0)
    cross = valid & (((d < 0) & (dj > 0)) | ((dj < 0) & (d > 0)))
    t = d / torch.where(cross, d - dj, torch.ones_like(d))
    cand = torch.stack([poly, poly + t[..., None] * (pj - poly)], 2)
    used = torch.stack([keep, cross], 2).reshape(p, 2 * k)
    order = torch.sort((~used).to(torch.uint8), dim=1,
                       stable=True).indices[:, :k]
    out = cand.reshape(p, 2 * k, 2).gather(
        1, order[..., None].expand(-1, -1, 2))
    return out, used.sum(1)


def rotated_iou_matrix_plain(boxes: torch.Tensor,
                             rows_per_chunk: int = 0) -> torch.Tensor:
    """(N, N) f64 rotated-BEV IoU of (N, D>=7) boxes: entry (k, i) is
    :func:`_rotated_iou_np` (boxes[k], boxes[i]) (box k's polygon clipped
    by box i's four half-planes), computed for all pairs at once on the
    boxes' device, ``rows_per_chunk`` rows at a time (0: about 2^18 pairs
    a chunk)."""
    b = boxes.double()
    n = b.shape[0]
    rows_per_chunk = rows_per_chunk or max(1, (1 << 18) // max(n, 1))
    c, s = torch.cos(b[:, 6]), torch.sin(b[:, 6])
    hw, hl = 0.5 * b[:, 3], 0.5 * b[:, 4]
    lx = torch.stack([hw, -hw, -hw, hw], -1)
    ly = torch.stack([hl, hl, -hl, -hl], -1)
    corners = torch.stack([b[:, :1] + lx * c[:, None] - ly * s[:, None],
                           b[:, 1:2] + lx * s[:, None] + ly * c[:, None]], -1)
    cx, cy = b[:, 0], b[:, 1]
    planes = [(c, s, hw + c * cx + s * cy), (-c, -s, hw - c * cx - s * cy),
              (-s, c, hl - s * cx + c * cy), (s, -c, hl + s * cx - c * cy)]
    area = b[:, 3] * b[:, 4]
    radius = 0.5 * torch.hypot(b[:, 3], b[:, 4])
    out = torch.zeros((n, n), dtype=torch.float64, device=b.device)
    for r0 in range(0, n, rows_per_chunk):
        rows = torch.arange(r0, min(n, r0 + rows_per_chunk),
                            device=b.device)
        kk = rows[:, None].expand(-1, n).reshape(-1)          # clipped box
        ii = torch.arange(n, device=b.device).repeat(len(rows))
        poly = torch.zeros((len(kk), 8, 2), dtype=torch.float64,
                           device=b.device)
        poly[:, :4] = corners[kk]
        cnt = torch.full((len(kk),), 4, dtype=torch.long, device=b.device)
        dead = torch.zeros(len(kk), dtype=torch.bool, device=b.device)
        for nx, ny, cc in planes:
            dead |= cnt < 3
            poly, cnt = _clip_halfplane(poly, cnt, nx[ii], ny[ii], cc[ii])
        dead |= cnt < 3
        j = torch.arange(8, device=b.device)[None]
        nxt = torch.where(j + 1 < cnt[:, None], j + 1, 0)
        x, y = poly[..., 0], poly[..., 1]
        term = x * y.gather(1, nxt) - x.gather(1, nxt) * y
        inter = 0.5 * torch.where(j < cnt[:, None], term, 0.0).sum(1)
        a1, a2 = area[kk], area[ii]
        inter = torch.minimum(torch.minimum(inter.clamp(min=0.0), a1), a2)
        iou = inter / (a1 + a2 - inter)
        far = ((cx[kk] - cx[ii]) ** 2 + (cy[kk] - cy[ii]) ** 2
               > (radius[kk] + radius[ii]) ** 2)
        zero = dead | far | (a1 <= 0) | (a2 <= 0)
        out[rows] = torch.where(zero, 0.0, iou).reshape(len(rows), n)
    return out


def greedy_kept(sup: np.ndarray, scores: np.ndarray, score_thr: float,
                max_num: int):
    """The rows that the greedy multi-class NMS keeps over a given
    suppression matrix ``sup`` (N, N) bool (a kept k suppresses i where
    sup[k, i]): per class by descending score, ties by index, then the
    top ``max_num`` by (score desc, class, index), as
    :func:`nms_rotated_multiclass_plain` orders them -> sorted [(class,
    index, score)]."""
    kept = []
    for cl in range(scores.shape[1]):
        cand = np.nonzero(scores[:, cl] > score_thr)[0]
        alive = []
        for i in cand[np.lexsort((cand, -scores[cand, cl]))]:
            if not (alive and sup[alive, i].any()):
                alive.append(i)
                kept.append((float(scores[i, cl]), cl, int(i)))
    kept.sort(key=lambda t: (-t[0], t[1], t[2]))
    return sorted((cl, i, sc) for sc, cl, i in kept[:max_num])


def nms_rotated_multiclass_plain(boxes: np.ndarray, scores: np.ndarray,
                                 score_thr: float, iou_thr: float,
                                 max_num: int):
    """Plain NumPy version of :func:`nms_rotated_multiclass_host`."""
    n, c = scores.shape
    kept = []  # (score, cls, idx)
    for cl in range(c):
        cand = np.nonzero(scores[:, cl] > score_thr)[0]
        order = cand[np.lexsort((cand, -scores[cand, cl]))]
        alive = []
        for i in order:
            if all(_rotated_iou_np(boxes[k], boxes[i]) <= iou_thr
                   for k in alive):
                alive.append(i)
                kept.append((float(scores[i, cl]), cl, int(i)))
    kept.sort(key=lambda t: (-t[0], t[1], t[2]))
    kept = kept[:max_num]
    out_boxes = np.zeros((max_num, boxes.shape[-1]), np.float32)
    out_scores = np.zeros((max_num,), np.float32)
    out_labels = np.zeros((max_num,), np.int32)
    out_valid = np.zeros((max_num,), bool)
    for o, (sc, cl, i) in enumerate(kept):
        out_boxes[o] = boxes[i]
        out_scores[o] = sc
        out_labels[o] = cl
        out_valid[o] = True
    return out_boxes, out_scores, out_labels, out_valid


def nms_rotated_multiclass_host(
        boxes: np.ndarray, scores: np.ndarray, score_thr: float,
        iou_thr: float, max_num: int) -> Tuple[np.ndarray, ...]:
    """One sample's multi-class rotated NMS in the native core.

    boxes: (N, D>=7) float32; scores: (N, C) float32.  Returns padded
    ``(max_num, D)`` boxes, scores, int32 labels, bool validity: the
    contract of the in-graph ``multiclass_nms_rotated``.
    """
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n, c = scores.shape
    d = boxes.shape[-1]
    out_boxes = np.empty((max_num, d), np.float32)
    out_scores = np.empty((max_num,), np.float32)
    out_labels = np.empty((max_num,), np.int32)
    cnt = get_lib().nms_rotated_multiclass(
        boxes, scores, n, c, d, float(score_thr), float(iou_thr),
        int(max_num), out_boxes, out_scores, out_labels)
    out_valid = np.arange(max_num) < cnt
    return out_boxes, out_scores, out_labels, out_valid


def nms_rotated_multiclass_host_batch(boxes: np.ndarray, scores: np.ndarray,
                                      score_thr: float, iou_thr: float,
                                      max_num: int):
    """Batched host NMS: (B, N, D) boxes + (B, N, C) scores."""
    outs = [nms_rotated_multiclass_host(b, s, score_thr, iou_thr, max_num)
            for b, s in zip(boxes, scores)]
    return tuple(np.stack(x) for x in zip(*outs))
