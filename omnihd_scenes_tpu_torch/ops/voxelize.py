"""Hard voxelization and the pillar scatter (counterpart of
``omnihd_scenes_tpu/ops/voxelize.py``), batched, with static shapes.

Points are bucketed by linearised pillar id, sorted once (stable, as
``jnp.argsort`` is) and written into a ``(max_voxels, max_points, D)``
buffer per sample; points past either capacity are dropped, as the JAX
``mode='drop'`` scatter drops them.  Here a dropped point, or an invalid
pillar in :func:`scatter_to_bev`, goes to one extra sentinel row that is
sliced off.  ``(x - x0) / vx`` is written ``(x - x0) * (1 / vx)``, which
is what jitted JAX computes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class VoxelizationOutput(NamedTuple):
    """features (B, V, P, D) zero padded; num_points (B, V) int32; coords
    (B, V, 2) int32 (iy, ix), 0 where invalid; valid (B, V) bool."""

    features: torch.Tensor
    num_points: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor


def voxelize(points, points_mask, point_cloud_range: Sequence[float],
             voxel_size: Sequence[float], max_voxels: int,
             max_points: int) -> VoxelizationOutput:
    """points (B, N, D) padded, dims 0:3 xyz; points_mask (B, N) bool."""
    b, n, d = points.shape
    dev = points.device
    x0, y0, z0, x1, y1, z1 = point_cloud_range
    vx, vy = voxel_size[0], voxel_size[1]
    grid_w = int(round((x1 - x0) / vx))
    grid_h = int(round((y1 - y0) / vy))

    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    ix = torch.floor((px - x0) * (1.0 / vx)).to(torch.int64)
    iy = torch.floor((py - y0) * (1.0 / vy)).to(torch.int64)
    valid = ((px >= x0) & (px < x1) & (py >= y0) & (py < y1) & (pz >= z0)
             & (pz < z1) & points_mask.bool())
    ix = ix.clamp(0, grid_w - 1)
    iy = iy.clamp(0, grid_h - 1)
    big = grid_w * grid_h                  # invalid points sort last
    lin = torch.where(valid, iy * grid_w + ix, big)

    lin_s, order = torch.sort(lin, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, d))
    valid_s = lin_s < big

    # Segments of equal ids in the sorted order: voxel rank, slot in voxel.
    new_seg = torch.ones_like(valid_s)
    new_seg[:, 1:] = lin_s[:, 1:] != lin_s[:, :-1]
    new_seg &= valid_s
    seg_rank = torch.cumsum(new_seg, 1) - 1
    arange = torch.arange(n, device=dev).expand(b, n)
    seg_start = torch.cummax(torch.where(new_seg, arange, 0), 1).values
    pos = arange - seg_start

    keep = valid_s & (seg_rank < max_voxels) & (pos < max_points)
    bidx = torch.arange(b, device=dev)[:, None]
    voxel = torch.where(keep, bidx * max_voxels + seg_rank, b * max_voxels)
    slot = torch.where(keep, voxel * max_points + pos,
                       b * max_voxels * max_points)

    features = points.new_zeros((b * max_voxels * max_points + 1, d))
    features[slot.reshape(-1)] = torch.where(keep[..., None], pts_s,
                                             0.0).reshape(-1, d)
    num_points = torch.zeros(b * max_voxels + 1, dtype=torch.int32,
                             device=dev)
    num_points.index_add_(0, voxel.reshape(-1),
                          keep.reshape(-1).to(torch.int32))
    iyx = torch.stack([lin_s // grid_w, lin_s % grid_w], -1)
    coords = torch.zeros((b * max_voxels + 1, 2), dtype=torch.int32,
                         device=dev)
    coords[voxel.reshape(-1)] = torch.where(keep[..., None], iyx,
                                            0).reshape(-1, 2).to(torch.int32)

    num_points = num_points[:-1].view(b, max_voxels)
    return VoxelizationOutput(
        features[:-1].view(b, max_voxels, max_points, d), num_points,
        coords[:-1].view(b, max_voxels, 2), num_points > 0)


def scatter_to_bev(pillar_features, coords, valid, grid_hw: Sequence[int]):
    """PointPillarsScatter: (B, V, C) pillar features -> (B, C, H, W)
    canvas (an NCHW view of an NHWC buffer); invalid pillars are
    dropped."""
    b, v, c = pillar_features.shape
    h, w = grid_hw
    bidx = torch.arange(b, device=coords.device)[:, None]
    cell = (bidx * h + coords[..., 0].long()) * w + coords[..., 1].long()
    cell = torch.where(valid, cell, b * h * w)
    canvas = pillar_features.new_zeros((b * h * w + 1, c))
    canvas = canvas.index_put((cell.reshape(-1),),
                              pillar_features.reshape(-1, c))
    return canvas[:-1].view(b, h, w, c).permute(0, 3, 1, 2)
