"""BEVFusion camera + 4D-radar detector (counterpart of
``omnihd_scenes_tpu/models/bevfusion.py``), serving configuration.

radar: DensePillarEncoder -> SECOND -> SECONDFPN -> (B, 384, 160, 240);
camera: ResNet -> FPNC -> LiftSplatShoot (DepthNet, sampling splat) ->
(B, 256, 160, 240); fusion: concat -> 3x3 ConvBNReLU -> SE gate ->
Anchor3DHead.  RCFusion's cross-modal fuser, single-stream variants, the
sorted pillar path and the space-to-depth stem are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import BEVFusionConfig
from omnihd_scenes_tpu_torch.models.anchor_head import Anchor3DHead
from omnihd_scenes_tpu_torch.models.fpnc import FPNC
from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU, SEBlock
from omnihd_scenes_tpu_torch.models.lss import LiftSplatShoot
from omnihd_scenes_tpu_torch.models.pillar_encoders import DensePillarEncoder
from omnihd_scenes_tpu_torch.models.resnet import ResNet
from omnihd_scenes_tpu_torch.models.second import SECOND, SECONDFPN

RADAR_POINT_DIMS = 8


def check_supported(cfg: BEVFusionConfig) -> None:
    """Raise for configuration values the port does not implement yet."""
    unsupported = {
        'camera_stream': cfg.camera_stream is not True,
        'radar_stream': cfg.radar_stream is not True,
        'lc_fusion': cfg.lc_fusion is not True,
        'rc_fusion': cfg.rc_fusion != 'concat',
        'stem_s2d': cfg.stem_s2d,
        'with_head': cfg.with_head is not True,
        'lss.splat_mode': cfg.lss.splat_mode != 'sample',
        'pillars.pillar_impl': cfg.pillars.pillar_impl != 'dense',
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(f'not ported yet: {bad}')


class BEVFusion(nn.Module):
    """Fusion detector over padded inputs.

    forward(points (B, P, 8), points_mask (B, P), imgs (B, N, H, W, 3),
    rots (B, N, 3, 3), trans (B, N, 3)) returns a dict of JAX-layout
    views: 'bev' (B, H, W, C), 'cls_score' / 'bbox_pred' / 'dir_pred'
    (B, H, W, A*K), 'depth' / 'depth_logits' (B, N, fH, fW, D).
    """

    def __init__(self, cfg: BEVFusionConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pc = cfg.pillars
        self.pillar_encoder = DensePillarEncoder(
            RADAR_POINT_DIMS, pc.pfn_channels, pc.voxel_size,
            pc.point_cloud_range, pc.bev_hw, pc.with_velocity_snr_center)
        self.second = SECOND(pc.pfn_channels[-1], pc.second_layer_nums,
                             pc.second_strides, pc.second_channels)
        self.second_fpn = SECONDFPN(pc.second_channels, pc.fpn_strides,
                                    pc.fpn_channels)
        self.resnet = ResNet(cfg.resnet_depth, cfg.resnet_out_indices)
        self.fpnc = FPNC(self.resnet.out_channels, 256, cfg.imc,
                         cfg.lss.feat_hw)
        self.lss = LiftSplatShoot(cfg.lss, cfg.imc, cfg.use_depthnet)
        self.fuse = ConvBNReLU(cfg.lss.outC + sum(pc.fpn_channels), cfg.lic)
        self.se = SEBlock(cfg.lic) if cfg.se else None
        self.head = Anchor3DHead(cfg.head_channels, pc.num_classes,
                                 pc.num_anchors)

    def forward(self, points, points_mask, imgs, rots, trans):
        canvas = self.pillar_encoder(points, points_mask)
        pts_bev = self.second_fpn(self.second(canvas))

        b, n = imgs.shape[:2]
        # NHWC images viewed as NCHW: channels_last memory, no copy.
        flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
        feat = self.fpnc(self.resnet(flat.to(self.fuse.conv.weight.dtype)))
        cam_bev, depth, depth_logits = self.lss(feat, rots, trans)
        if cam_bev.shape[-2:] != pts_bev.shape[-2:]:
            raise NotImplementedError(
                f'camera BEV {tuple(cam_bev.shape[-2:])} != radar BEV '
                f'{tuple(pts_bev.shape[-2:])}: the resize is not ported')

        fused = self.fuse(torch.cat([cam_bev, pts_bev], dim=1))
        if self.se is not None:
            fused = self.se(fused)
        cls_score, bbox_pred, dir_pred = self.head(fused)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {'cls_score': nhwc(cls_score), 'bbox_pred': nhwc(bbox_pred),
                'dir_pred': nhwc(dir_pred), 'bev': nhwc(fused),
                'depth': depth, 'depth_logits': depth_logits}
