"""Single-modality point-cloud detectors (counterpart of
``omnihd_scenes_tpu/models/detectors.py``): PointPillars on radar or
LiDAR points, and RadarPillarNet (``with_velocity_snr_center=True``).

voxelize -> PillarFeatureNet -> scatter (``pillar_impl='sorted'``, the
configuration that trains) or DensePillarEncoder (``'dense'``, or
``'dense_fold'`` with its frozen BN folded through the max-pool in eval
mode) -> SECOND
-> SECONDFPN -> Anchor3DHead.  flax infers the PFN's input width from the
points; here it is ``point_dims``, the dataset's point width
(``data/dataset.py:NewScenesDetDataset.point_dim``: 8 for radar, 4 for the
shipped LiDAR config).  :class:`PillarBackbone` is the pillar stream that
BEVFusion's radar branch shares, under the same module names.
"""

from __future__ import annotations

from torch import nn

from omnihd_scenes_tpu_torch.config import PointPillarsConfig
from omnihd_scenes_tpu_torch.models.anchor_head import Anchor3DHead
from omnihd_scenes_tpu_torch.models.pillar_encoders import (
    DensePillarEncoder, PillarFeatureNet)
from omnihd_scenes_tpu_torch.models.second import SECOND, SECONDFPN
from omnihd_scenes_tpu_torch.ops.voxelize import scatter_to_bev, voxelize


class PillarBackbone(nn.Module):
    """The pillar stream: ``pillar_encoder``, ``second`` and ``second_fpn``
    (the names the weight bridge maps)."""

    def _init_pillars(self, pc: PointPillarsConfig, point_dims: int):
        if pc.pillar_impl not in ('dense', 'dense_fold', 'sorted'):
            raise ValueError(f'unknown pillar_impl {pc.pillar_impl!r}')
        self.pillar_cfg = pc
        self.point_dims = point_dims
        if pc.pillar_impl != 'sorted':
            self.pillar_encoder = DensePillarEncoder(
                point_dims, pc.pfn_channels, pc.voxel_size,
                pc.point_cloud_range, pc.bev_hw, pc.with_velocity_snr_center,
                fold_bn=pc.pillar_impl == 'dense_fold')
        else:
            self.pillar_encoder = PillarFeatureNet(
                point_dims, pc.pfn_channels, pc.voxel_size,
                pc.point_cloud_range, pc.with_velocity_snr_center)
        self.second = SECOND(pc.pfn_channels[-1], pc.second_layer_nums,
                             pc.second_strides, pc.second_channels)
        self.second_fpn = SECONDFPN(pc.second_channels, pc.fpn_strides,
                                    pc.fpn_channels)

    def pillar_canvas(self, points, points_mask):
        """Points (B, P, D) + mask (B, P) -> the (B, C, H, W) pillar canvas
        (channels_last)."""
        pc = self.pillar_cfg
        if pc.pillar_impl != 'sorted':
            return self.pillar_encoder(points, points_mask)
        vox = voxelize(points, points_mask, pc.point_cloud_range,
                       pc.voxel_size, pc.max_voxels, pc.max_points_per_voxel)
        pf = self.pillar_encoder(vox.features, vox.num_points, vox.coords)
        return scatter_to_bev(pf, vox.coords, vox.valid, pc.bev_hw)

    def pillar_bev(self, points, points_mask):
        """Points -> the (B, sum(fpn_channels), H', W') SECONDFPN map."""
        return self.second_fpn(self.second(self.pillar_canvas(points,
                                                              points_mask)))


class PointPillars(PillarBackbone):
    """Pillar detector over a padded (B, P, point_dims) point buffer.

    forward(points, points_mask) returns JAX-layout views: 'cls_score' /
    'bbox_pred' / 'dir_pred' (B, H, W, A*K) and 'bev' (B, H, W, C).
    """

    def __init__(self, cfg: PointPillarsConfig, point_dims: int = 8):
        super().__init__()
        self.cfg = cfg
        self._init_pillars(cfg, point_dims)
        self.head = Anchor3DHead(sum(cfg.fpn_channels), cfg.num_classes,
                                 cfg.num_anchors)

    def forward(self, points, points_mask):
        return self.head.outputs(self.pillar_bev(points, points_mask))
