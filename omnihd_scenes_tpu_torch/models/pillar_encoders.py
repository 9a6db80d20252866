"""Radar pillar encoders (counterpart of
``omnihd_scenes_tpu/models/pillar_encoders.py``).

:class:`PillarFeatureNet` (``pillar_impl='sorted'``, the configuration
that trains) encodes the static (B, V, P, D) voxel buffers of
:func:`omnihd_scenes_tpu_torch.ops.voxelize.voxelize`: each point gains
its offsets from the pillar's mean and centre, then Linear -> BN -> ReLU
-> a max over the pillar's points, padding masked out.  The PFN
BatchNorm's batch statistics run over every (B, V, P) slot, padding
included, as in JAX.

:class:`DensePillarEncoder` (``pillar_impl='dense'``, the serving path)
is its sort-free form.  Every pillar statistic is a scatter straight onto the BEV grid:
counts/sums by ``index_add_``, the per-point augmentation by a gather of
the pillar means, the PFN max-pool by ``scatter_reduce('amax')``.
Invalid points (masked or out of range) go to one extra sentinel row
that is sliced off, the torch form of JAX's ``mode='drop'``; cells no
point reaches stay 0, as JAX's ``where(counts > 0, canvas, 0)``.  The
BN-folded variant (``pillar_impl='dense_fold'``) is not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import BN_EPS, BatchNorm


class PFNLayer(nn.Module):
    """Per-point Linear (no bias) -> BN -> ReLU over (..., C) points; the
    BN's batch statistics run over every leading slot."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=False)
        self.bn = BatchNorm(out_features, BN_EPS)

    def forward(self, x):
        y = self.linear(x)
        return F.relu(self.bn(y.reshape(-1, y.shape[-1])).view(y.shape))


def _augment_pillar_features(features, num_points, coords,
                             voxel_size: Sequence[float],
                             point_cloud_range: Sequence[float],
                             with_velocity_snr_center: bool = False):
    """features (..., V, P, D) -> (..., V, P, D + 5 [+ 4]): the points,
    their offsets from the pillar's mean xyz and from the pillar centre
    (xy) [and from the mean velocity / SNR of dims 3:7], zero in the
    padding slots."""
    denom = num_points.clamp(min=1).to(features.dtype)[..., None, None]
    mean_xyz = features[..., :3].sum(-2, keepdim=True) / denom
    vx, vy = voxel_size[0], voxel_size[1]
    # coords = (iy, ix)
    cx = coords[..., 1].to(features.dtype)[..., None] * vx \
        + (vx / 2 + point_cloud_range[0])
    cy = coords[..., 0].to(features.dtype)[..., None] * vy \
        + (vy / 2 + point_cloud_range[1])
    feats = [features, features[..., :3] - mean_xyz,
             torch.stack([features[..., 0] - cx, features[..., 1] - cy], -1)]
    if with_velocity_snr_center:
        mean_v = features[..., 3:7].sum(-2, keepdim=True) / denom
        feats.append(features[..., 3:7] - mean_v)
    out = torch.cat(feats, -1)
    return torch.where(_point_mask(num_points, features.shape[-2]), out, 0.0)


def _point_mask(num_points, slots):
    """(..., V, P, 1): slot p of a pillar holds a point."""
    return (torch.arange(slots, device=num_points.device)
            < num_points[..., None])[..., None]


class PillarFeatureNet(nn.Module):
    """Voxel buffers -> (..., V, C) pillar features: features (..., V, P,
    D), num_points (..., V), coords (..., V, 2) (iy, ix).  Pillars with no
    point get 0."""

    def __init__(self, in_channels: int = 8,
                 feat_channels: Tuple[int, ...] = (64,),
                 voxel_size: Sequence[float] = (0.25, 0.25, 8.0),
                 point_cloud_range: Sequence[float] = (-60, -40, -3.0, 60, 40,
                                                       5.0),
                 with_velocity_snr_center: bool = False):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.with_velocity_snr_center = with_velocity_snr_center
        d_in = in_channels + 5 + (4 if with_velocity_snr_center else 0)
        layers = []
        for ch in feat_channels:
            layers.append(PFNLayer(d_in, ch))
            d_in = 2 * ch                     # points + the pooled feature
        self.pfn = nn.ModuleList(layers)

    def forward(self, features, num_points, coords):
        x = _augment_pillar_features(features, num_points, coords,
                                     self.voxel_size, self.point_cloud_range,
                                     self.with_velocity_snr_center)
        mask = _point_mask(num_points, features.shape[-2])
        for i, layer in enumerate(self.pfn):
            x = layer(x.to(layer.linear.weight.dtype))
            pooled = torch.where(mask, x, -torch.inf).amax(-2)
            pooled = torch.where(num_points[..., None] > 0, pooled, 0.0)
            if i == len(self.pfn) - 1:
                return pooled
            x = torch.cat([torch.where(mask, x, 0.0),
                           pooled[..., None, :].expand_as(x)], -1)


class DensePillarEncoder(nn.Module):
    """Points (B, P, D) + mask (B, P) -> BEV canvas (B, C, H, W).

    The canvas comes back as an NCHW view of an NHWC buffer, i.e. in
    channels_last memory.
    """

    def __init__(self, in_channels: int = 8,
                 feat_channels: Tuple[int, ...] = (64,),
                 voxel_size: Sequence[float] = (0.25, 0.25, 8.0),
                 point_cloud_range: Sequence[float] = (-60, -40, -3.0, 60, 40,
                                                       5.0),
                 grid_hw: Tuple[int, int] = (320, 480),
                 with_velocity_snr_center: bool = False):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_hw = tuple(grid_hw)
        self.with_velocity_snr_center = with_velocity_snr_center
        # points + cluster offset (3) + pillar-centre offset (2) [+ v/SNR (4)]
        d_in = in_channels + 5 + (4 if with_velocity_snr_center else 0)
        layers = []
        for ch in feat_channels:
            layers.append(PFNLayer(d_in, ch))
            d_in = 2 * ch                     # layer output + pooled canvas
        self.pfn = nn.ModuleList(layers)

    def forward(self, points, points_mask):
        b, n, d = points.shape
        h, w = self.grid_hw
        hw = h * w
        x0, y0, z0, x1, y1, z1 = self.point_cloud_range
        vx, vy = self.voxel_size[0], self.voxel_size[1]

        pts = points.reshape(b * n, d)
        # Jitted JAX's form of ``/ vx``: a multiply by the f32 reciprocal
        # (as ops/voxelize.py), which floors some bin edges differently.
        ix = torch.floor((pts[:, 0] - x0) * (1.0 / vx))
        iy = torch.floor((pts[:, 1] - y0) * (1.0 / vy))
        valid = ((pts[:, 0] >= x0) & (pts[:, 0] < x1)
                 & (pts[:, 1] >= y0) & (pts[:, 1] < y1)
                 & (pts[:, 2] >= z0) & (pts[:, 2] < z1)
                 & points_mask.reshape(b * n).bool())
        ix = torch.where(valid, ix, 0).long().clamp(0, w - 1)
        iy = torch.where(valid, iy, 0).long().clamp(0, h - 1)
        bidx = torch.arange(b, device=pts.device).repeat_interleave(n)
        cell = bidx * hw + iy * w + ix
        lin = torch.where(valid, cell, b * hw)            # sentinel row
        lin_g = torch.where(valid, cell, 0)               # safe gather index

        stat_cols = [torch.ones_like(pts[:, :1]), pts[:, :3]]
        if self.with_velocity_snr_center:
            stat_cols.append(pts[:, 3:7])
        stats = torch.where(valid[:, None], torch.cat(stat_cols, -1), 0.0)
        sums = pts.new_zeros((b * hw + 1, stats.shape[-1]))
        sums.index_add_(0, lin, stats)
        counts = sums[:, :1]
        means = sums[:, 1:] / counts.clamp(min=1.0)
        pmean = means[lin_g]

        feats = [pts, pts[:, :3] - pmean[:, :3]]
        cx = ix.to(pts.dtype) * vx + (vx / 2 + x0)
        cy = iy.to(pts.dtype) * vy + (vy / 2 + y0)
        feats.append(torch.stack([pts[:, 0] - cx, pts[:, 1] - cy], -1))
        if self.with_velocity_snr_center:
            feats.append(pts[:, 3:7] - pmean[:, 3:])
        x = torch.where(valid[:, None], torch.cat(feats, -1), 0.0)

        canvas = None
        for i, layer in enumerate(self.pfn):
            x = layer(x.to(layer.linear.weight.dtype))
            ch = x.shape[-1]
            # Scatter-max in at least f32 whatever the network dtype.
            src = x.to(torch.promote_types(x.dtype, torch.float32))
            canvas = src.new_zeros((b * hw + 1, ch)).scatter_reduce_(
                0, lin[:, None].expand(-1, ch), src, 'amax',
                include_self=False)
            if i != len(self.pfn) - 1:
                x = torch.cat([x, canvas[lin_g].to(x.dtype)], -1)
                x = torch.where(valid[:, None], x, 0.0)
        canvas = canvas[:b * hw].to(x.dtype)
        return canvas.view(b, h, w, -1).permute(0, 3, 1, 2)
