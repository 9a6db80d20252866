"""Multi-task detection + occupancy model, BEVFusion-OCC (counterpart of
``omnihd_scenes_tpu/models/mtl.py``).

Parity targets (reference):
- ``MultiTaskHeadv2`` (``bevfusion/dense_heads/mtl_occ_det_headv2.py
  :21-183``): per-task ``BevFeatureSlicer`` grid crops + task decoders
  ('3dod' -> Anchor3DHead, 'occ' -> BEVOCCHead2Dv2);
- ``BevFeatureSlicer`` (``dense_heads/map_head.py:37-78``): bilinear BEV
  re-gridding, the identity when the grids coincide;
- ``BEV_FasterRCNN_MTL`` (``bevfusion/detectors/bevf_faster_rcnn_MTL.py
  :31-327``): the BEVFusion trunk feeding the multi-task head.

``forward`` returns the fusion trunk's JAX-layout dict ('bev', the depth
maps, the head maps (B, H, W, A*K)) plus 'occ_logits' (B, Dx, Dy, Dz,
n_cls).  ``trunk_mode`` 'per_task' and 'shared' build the fusion trunk
without its head and own a ``det_head`` after their BEV trunk(s).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import MTLConfig
from omnihd_scenes_tpu_torch.models.anchor_head import Anchor3DHead
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.fpnc import resize_bilinear
from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU
from omnihd_scenes_tpu_torch.models.occ_head import BEVOCCHead2D
from omnihd_scenes_tpu_torch.models.resnet import BasicBlock
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import bilinear_sample


def bev_feature_slice(bev, src_grid, dst_grid):
    """Resample a (B, C, H, W) BEV from one grid spec to another (a grid
    spec is (xbound, ybound), bound = (min, max, step)); the identity when
    the grids match.  The cell centres are computed in f32 (f64 for an f64
    BEV), each division by a step as a multiply by its reciprocal, as
    jitted JAX computes them."""
    if src_grid == dst_grid:
        return bev
    (sx0, _, sdx), (sy0, _, sdy) = src_grid
    (dx0, dx1, ddx), (dy0, dy1, ddy) = dst_grid
    h = int(round((dy1 - dy0) / ddy))
    w = int(round((dx1 - dx0) / ddx))
    dt = torch.float64 if bev.dtype == torch.float64 else torch.float32
    xs = dx0 + (torch.arange(w, dtype=dt, device=bev.device) + 0.5) * ddx
    ys = dy0 + (torch.arange(h, dtype=dt, device=bev.device) + 0.5) * ddy
    px = (xs - sx0) * (1.0 / sdx) - 0.5
    py = (ys - sy0) * (1.0 / sdy) - 0.5
    gy, gx = torch.meshgrid(py, px, indexing='ij')
    loc = torch.stack([gx, gy], -1).expand(bev.shape[0], h, w, 2)
    out = bilinear_sample(bev.permute(0, 2, 3, 1), loc)     # (B, h, w, C)
    return out.permute(0, 3, 1, 2).to(bev.dtype)


def occupancy_shape(cfg: MTLConfig):
    """(Dx, Dy, Dz) of the occupancy logits: the LSS grid, or the
    occupancy crop's grid.  The trunk modes keep the spatial size of an
    even-sized grid."""
    grid, dst = cfg.grid_conf, cfg.occ_grid_conf
    if grid is None or dst is None or grid == dst:
        nx, ny, _ = cfg.fusion.lss.bev_nx
        return nx, ny, cfg.occ_dz
    (dx0, dx1, ddx), (dy0, dy1, ddy) = dst
    return (int(round((dx1 - dx0) / ddx)), int(round((dy1 - dy0) / ddy)),
            cfg.occ_dz)


class BevEncodeTrunk(nn.Module):
    """Small ResNet18-style BEV trunk (reference ``BevEncode``):
    (B, C, H, W) -> (B, out_channels, H', W') with H' = 2 * ceil(H / 2)."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.stem = ConvBNReLU(in_channels, 64, 7, stride=2)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, stride=2),
                                    BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, stride=2),
                                    BasicBlock(256, 256))
        self.up1 = ConvBNReLU(64 + 256, 256)
        self.up2 = ConvBNReLU(256, 128)
        self.out = nn.Conv2d(128, out_channels, 1)

    def forward(self, x):
        x = self.stem(x)
        x1 = self.layer1(x)
        x3 = self.layer3(self.layer2(x1))
        y = self.up1(torch.cat([x1, resize_bilinear(x3, x1.shape[-2:])], 1))
        y = resize_bilinear(y, (x.shape[-2] * 2, x.shape[-1] * 2))
        return self.out(self.up2(y))


class BEVFusionMTL(nn.Module):
    """Fusion trunk + multi-task (detection, occupancy) heads.

    forward(points, points_mask, imgs, rots, trans) as BEVFusion's.
    """

    def __init__(self, cfg: MTLConfig, point_dims: int = 8):
        super().__init__()
        self.cfg = cfg
        fcfg = cfg.fusion
        own_det_head = cfg.enable_det and cfg.trunk_mode != 'none'
        if own_det_head:
            fcfg = dataclasses.replace(fcfg, with_head=False)
        self.fusion = BEVFusion(fcfg, point_dims)
        bev_c = fcfg.head_channels
        if cfg.trunk_mode == 'shared':
            self.shared_trunk = BevEncodeTrunk(bev_c, 256)
        task_c = 256 if cfg.trunk_mode == 'shared' else bev_c
        if own_det_head:
            det_c = task_c
            if cfg.trunk_mode == 'per_task':
                self.det_trunk = BevEncodeTrunk(task_c, 256)
                det_c = 256
            pc = fcfg.pillars
            self.det_head = Anchor3DHead(det_c, pc.num_classes,
                                         pc.num_anchors)
        if cfg.enable_occ:
            occ_c = task_c
            if cfg.trunk_mode == 'per_task':
                self.occ_trunk = BevEncodeTrunk(task_c, 256)
                occ_c = 256
            self.occ_head = BEVOCCHead2D(occ_c, 256, cfg.occ_dz,
                                         cfg.occ_classes)

    def _crop(self, x, dst_grid):
        grid = self.cfg.grid_conf
        if grid is None or dst_grid is None or grid == dst_grid:
            return x
        return bev_feature_slice(x, grid, dst_grid)

    def forward(self, points, points_mask, imgs, rots, trans):
        cfg = self.cfg
        out = self.fusion(points, points_mask, imgs, rots, trans)
        results = {k: out[k] for k in ('bev', 'depth', 'depth_logits')}
        bev = out['bev'].permute(0, 3, 1, 2)          # (B, C, Dy, Dx)
        if cfg.trunk_mode == 'shared':
            bev = self.shared_trunk(bev)
        if cfg.enable_det:
            if cfg.trunk_mode == 'none':
                results.update({k: out[k] for k in ('cls_score', 'bbox_pred',
                                                    'dir_pred')})
            else:
                det = self._crop(bev, cfg.det_grid_conf)
                if cfg.trunk_mode == 'per_task':
                    det = self.det_trunk(det)
                maps = self.det_head.outputs(det)
                del maps['bev']
                results.update(maps)
        if cfg.enable_occ:
            occ = self._crop(bev, cfg.occ_grid_conf)
            if cfg.trunk_mode == 'per_task':
                occ = self.occ_trunk(occ)
            results['occ_logits'] = self.occ_head(occ)
        return results
