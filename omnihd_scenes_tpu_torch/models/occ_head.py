"""Semantic occupancy heads and their losses (counterpart of
``omnihd_scenes_tpu/models/occ_head.py``).

Parity targets (reference):
- ``BEVOCCHead2Dv2`` (``bevfusion/dense_heads/bev_occ_head.py:720-831``):
  3x3 conv on the BEV -> per-column MLP predicter (Linear -> Softplus ->
  Linear) -> (Dx, Dy, Dz, n_cls) logits; loss = CE + sem_scal + geo_scal;
- ``geo_scal_loss`` / ``sem_scal_loss`` (``:805-876``);
- Lovasz-softmax (``bevfusion/losses/lovasz_softmax.py``) for the 3D-head
  variants.

Class 0 is free space; semantic classes are 1..n_cls-1; 255 marks unknown
voxels (masked out).  The heads take the port's NCHW BEV (B, C, Dy, Dx)
and return the JAX layout (B, Dx, Dy, Dz, n_cls).  The softplus is
``log(1 + exp(x))`` without torch's linear branch above 20, as
``jax.nn.softplus`` computes it.  The losses run in the logits' dtype,
except the 0/1 target masks and what is built from them alone (counts,
Lovasz's Jaccard terms), which are f32 as in JAX, also for f64 logits.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.losses import softmax_cross_entropy


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class BEVOCCHead2D(nn.Module):
    """BEV (B, C, Dy, Dx) -> occupancy logits (B, Dx, Dy, Dz, n_cls)."""

    def __init__(self, in_channels: int, out_dim: int = 256, dz: int = 16,
                 num_classes: int = 12, use_predicter: bool = True):
        super().__init__()
        self.dz, self.num_classes = dz, num_classes
        self.use_predicter = use_predicter
        self.conv = nn.Conv2d(in_channels, out_dim if use_predicter
                              else num_classes * dz, 3, padding=1)
        if use_predicter:
            self.fc1 = nn.Linear(out_dim, out_dim * 2)
            self.fc2 = nn.Linear(out_dim * 2, num_classes * dz)

    def forward(self, bev):
        x = self.conv(bev).permute(0, 3, 2, 1)        # (B, Dx, Dy, C)
        if self.use_predicter:
            x = self.fc2(softplus(self.fc1(x)))
        return x.reshape(*x.shape[:-1], self.dz, self.num_classes)


class BEVOCCHead3D(nn.Module):
    """3D-conv occupancy head (reference ``BEVOCCHead3D(v2)``): lift the
    BEV into a (Dy, Dx, Dz, C') volume, refine it with two 3x3x3 convs and
    classify each voxel."""

    def __init__(self, in_channels: int, mid_dim: int = 64, dz: int = 16,
                 num_classes: int = 12):
        super().__init__()
        self.dz, self.mid_dim = dz, mid_dim
        self.lift = nn.Linear(in_channels, dz * mid_dim)
        self.conv1 = nn.Conv3d(mid_dim, mid_dim, 3, padding=1)
        self.conv2 = nn.Conv3d(mid_dim, mid_dim, 3, padding=1)
        self.cls = nn.Linear(mid_dim, num_classes)

    def forward(self, bev):
        x = self.lift(bev.permute(0, 2, 3, 1))        # (B, Dy, Dx, Dz*C')
        x = x.reshape(*x.shape[:-1], self.dz, self.mid_dim)
        x = x.permute(0, 4, 1, 2, 3)                  # (B, C', Dy, Dx, Dz)
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = self.cls(x.permute(0, 2, 3, 4, 1))        # (B, Dy, Dx, Dz, K)
        return x.transpose(1, 2)                      # (B, Dx, Dy, Dz, K)


def _bce_scalar(p, eps: float = 1e-7):
    """binary_cross_entropy(p, 1) for a probability scalar."""
    return -torch.log(p.clamp(eps, 1.0))


def geo_scal_loss(logits, target):
    """Geometric scene-completion affinity loss (reference ``:805-833``)."""
    probs = torch.softmax(logits, dim=-1)
    empty = probs[..., 0]
    mask = target != 255
    nonempty_t = ((target != 0) & mask).float()
    nonempty_p = torch.where(mask, 1.0 - empty, 0.0)
    empty_p = torch.where(mask, empty, 0.0)
    empty_t = ((target == 0) & mask).float()

    inter = (nonempty_t * nonempty_p).sum()
    precision = inter / nonempty_p.sum().clamp(min=1e-6)
    recall = inter / nonempty_t.sum().clamp(min=1e-6)
    spec = (empty_t * empty_p).sum() / empty_t.sum().clamp(min=1e-6)
    return _bce_scalar(precision) + _bce_scalar(recall) + _bce_scalar(spec)


def sem_scal_loss(logits, target):
    """Per-class precision / recall / specificity BCE (reference
    ``:835-876``), averaged over the classes present in ``target``."""
    probs = torch.softmax(logits, dim=-1)
    mask = target != 255
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    total = zero
    count = torch.zeros((), device=probs.device)
    for i in range(logits.shape[-1]):
        p = torch.where(mask, probs[..., i], 0.0)
        t = ((target == i) & mask).float()
        has_cls = t.sum() > 0

        nom = (p * t).sum()
        precision = nom / p.sum().clamp(min=1e-6)
        recall = nom / t.sum().clamp(min=1e-6)
        not_t = torch.where(mask, 1.0 - t, 0.0)
        specificity = ((1.0 - p) * not_t).sum() / not_t.sum().clamp(min=1e-6)

        loss_cls = torch.where(p.sum() > 0, _bce_scalar(precision), zero)
        loss_cls = loss_cls + _bce_scalar(recall)
        loss_cls = loss_cls + torch.where(not_t.sum() > 0,
                                          _bce_scalar(specificity), zero)
        total = total + torch.where(has_cls, loss_cls, zero)
        count = count + has_cls.float()
    return total / count.clamp(min=1.0)


def lovasz_softmax_loss(logits, target):
    """Lovasz-softmax over the present classes, flattened formulation
    (reference ``bevfusion/losses/lovasz_softmax.py:22-328``); voxels
    labelled 255 are left out.  Errors are sorted by a stable descending
    sort, as ``jnp.argsort(-errors)`` orders them, so tied voxels take the
    same order and the gradient matches."""
    n_cls = logits.shape[-1]
    probs = torch.softmax(logits.reshape(-1, n_cls), dim=-1)
    labels = target.reshape(-1)
    valid = labels != 255
    labels_safe = torch.where(valid, labels, 0)
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    total = zero
    present = torch.zeros((), device=probs.device)
    for c in range(n_cls):
        fg = ((labels_safe == c) & valid).float()
        errors = torch.where(valid, (fg - probs[:, c]).abs(), -1.0)
        order = torch.argsort(-errors, stable=True)
        errors_s = errors[order]
        fg_s = fg[order]
        valid_s = errors_s >= 0.0
        gts = fg_s.sum()
        inter = gts - torch.cumsum(fg_s, 0)
        union = gts + torch.cumsum(1.0 - fg_s, 0)
        jaccard = 1.0 - inter / union.clamp(min=1e-6)
        grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        loss_c = (torch.where(valid_s, errors_s, 0.0) * grad).sum()
        is_present = gts > 0
        total = total + torch.where(is_present, loss_c, zero)
        present = present + is_present.float()
    return total / present.clamp(min=1.0)


def occ_head_loss(occ_logits, gt_occ,
                  use_lovasz: bool = False) -> Dict[str, torch.Tensor]:
    """(Dx, Dy, Dz, C) logits + (Dx, Dy, Dz) integer targets -> loss dict
    (reference ``BEVOCCHead2Dv2.loss``: CE + sem_scal + geo_scal)."""
    target = gt_occ.long()
    mask = target != 255
    safe = torch.where(mask, target, 0)
    ce = softmax_cross_entropy(occ_logits, safe)
    loss_occ = torch.where(mask, ce, 0.0).sum() / mask.sum().clamp(min=1)
    loss_ssc = (sem_scal_loss(occ_logits, target)
                + geo_scal_loss(occ_logits, target))
    out = {'loss_occ': loss_occ, 'loss_ssc': loss_ssc}
    if use_lovasz:
        out['loss_lovasz'] = lovasz_softmax_loss(occ_logits, target)
    return out
