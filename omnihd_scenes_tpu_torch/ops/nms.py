"""Rotated multi-class NMS (counterpart of ``omnihd_scenes_tpu/ops/nms.py``).

Greedy NMS as the suppression fixpoint

    alive_{k+1}[j] = valid[j] and not any_i(prec[i, j] and S[i, j] and alive_k[i])

iterated from ``alive_0 = valid``; its fixpoint is the greedy result.
The JAX ``while_loop`` stops at convergence or after 48 steps.  A
converged state is a fixed point, so 48 unconditional steps give the
same answer with no host sync per step.  Inputs may carry leading batch
dims; the whole batch is suppressed at once.  :func:`multiclass_nms_rotated`
is the span ``decode.nms`` (``utils/timing.py``).
"""

from __future__ import annotations

import torch

from omnihd_scenes_tpu_torch.ops.boxes3d import rotated_iou_bev
from omnihd_scenes_tpu_torch.utils.timing import span

MAX_FIXPOINT_ITERS = 48


def _precedence(scores):
    """prec[..., i, j]: box i is visited before box j (higher score
    first, ties by lower index)."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    si, sj = scores[..., :, None], scores[..., None, :]
    return (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))


def _greedy_fixpoint(s_mat, prec, valid, max_iters=MAX_FIXPOINT_ITERS):
    sp = s_mat & prec
    alive = valid
    for _ in range(max_iters):
        suppressed = (sp & alive[..., :, None]).any(dim=-2)
        alive = valid & ~suppressed
    return alive


def nms_rotated(boxes, scores, iou_threshold: float, valid=None):
    """Greedy rotated-BEV NMS of one class: (..., N, D) boxes, (..., N)
    scores, optional (..., N) bool ``valid`` -> the (..., N) bool keep
    mask (JAX's ``ops/nms.py:nms_rotated``; its IoU matrix is made
    symmetric as JAX mirrors its tiles)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    s_mat = rotated_iou_bev(boxes, boxes) > iou_threshold
    s_mat = s_mat | s_mat.transpose(-1, -2)
    neg_inf = torch.full((), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
    return _greedy_fixpoint(s_mat, _precedence(
        torch.where(valid, scores, neg_inf)), valid)


@span('decode.nms')
def multiclass_nms_rotated(boxes, scores, score_thr: float,
                           iou_threshold: float, max_num: int):
    """Per-class rotated NMS over (..., N, num_classes) scores.

    Class-wise NMS sharing one IoU matrix, then the top ``max_num`` kept
    (box, class) pairs by score (ties: lower index first, as
    ``jax.lax.top_k``).  Returns padded (..., max_num, D) boxes,
    (..., max_num) scores, int32 labels and bool validity.
    """
    n, num_classes = scores.shape[-2:]
    s_mat = rotated_iou_bev(boxes, boxes) > iou_threshold      # (..., N, N)
    cls_scores = scores.transpose(-1, -2)                      # (..., C, N)
    cand = cls_scores > score_thr
    neg_inf = torch.full((), -torch.inf, dtype=scores.dtype,
                         device=scores.device)      # no host-to-device copy
    prec = _precedence(torch.where(cand, cls_scores, neg_inf))
    keep = _greedy_fixpoint(s_mat[..., None, :, :], prec, cand)  # (..., C, N)

    flat_scores = torch.where(keep, cls_scores, neg_inf).flatten(-2)
    flat_keep = keep.flatten(-2)
    k = min(max_num, n * num_classes)
    top_scores, top_idx = torch.sort(flat_scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    box_idx = top_idx % n
    out_boxes = torch.gather(
        boxes, -2, box_idx[..., None].expand(*box_idx.shape, boxes.shape[-1]))
    out_labels = (top_idx // n).to(torch.int32)
    out_valid = torch.gather(flat_keep, -1, top_idx) & (top_scores > neg_inf)
    out_scores = torch.where(out_valid, top_scores,
                             torch.zeros_like(top_scores))
    if k < max_num:                       # pad to the static output size
        pad = max_num - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(
            *out_boxes.shape[:-2], pad, out_boxes.shape[-1])], dim=-2)
        out_scores, out_labels, out_valid = (
            torch.cat([t, t.new_zeros(*t.shape[:-1], pad)], dim=-1)
            for t in (out_scores, out_labels, out_valid))
    return out_boxes, out_scores, out_labels, out_valid
