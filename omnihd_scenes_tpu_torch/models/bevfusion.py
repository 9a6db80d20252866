"""BEVFusion camera + 4D-radar detector (counterpart of
``omnihd_scenes_tpu/models/bevfusion.py``), and its depth loss.

radar: voxelize -> PillarFeatureNet -> scatter (``pillar_impl='sorted'``,
the configuration that trains) or DensePillarEncoder (``'dense'``, the
serving configuration) -> SECOND -> SECONDFPN -> (B, 384, 160, 240);
camera: ResNet -> FPNC -> LiftSplatShoot (DepthNet, sampling splat) ->
(B, 256, 160, 240); fusion: concat -> 3x3 ConvBNReLU -> SE gate ->
Anchor3DHead.  Without the radar stream (``configs/lss_camera.py``, the
LSS camera-only model) the head reads the camera BEV directly, as in
JAX; with it but ``lc_fusion=False`` the head reads the radar BEV.
``model.train()`` is the JAX ``train=True``: batch statistics in every
BatchNorm but the frozen backbone's.  RCFusion's cross-modal fuser, the
camera-less variant, ``dense_fold``, remat and the space-to-depth stem
are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig
from omnihd_scenes_tpu_torch.models.anchor_head import Anchor3DHead
from omnihd_scenes_tpu_torch.models.detectors import PillarBackbone
from omnihd_scenes_tpu_torch.models.fpnc import FPNC
from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU, SEBlock
from omnihd_scenes_tpu_torch.models.lss import LiftSplatShoot
from omnihd_scenes_tpu_torch.models.resnet import ResNet


def check_supported(cfg: BEVFusionConfig) -> None:
    """Raise for configuration values the port does not implement yet
    (the pillar stream refuses its own, ``PillarBackbone``)."""
    unsupported = {
        'camera_stream': cfg.camera_stream is not True,
        'rc_fusion': cfg.rc_fusion != 'concat',
        'stem_s2d': cfg.stem_s2d,
        'with_head': cfg.with_head is not True,
        'lss.splat_mode': cfg.lss.splat_mode != 'sample',
        # torch.utils.checkpoint over the trunks; an 80 GB card holds the
        # b4 step without it.
        'remat': cfg.remat,
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(f'not ported yet: {bad}')


class BEVFusion(PillarBackbone):
    """Fusion detector over padded inputs.

    forward(points (B, P, point_dims), points_mask (B, P), imgs (B, N, H,
    W, 3), rots (B, N, 3, 3), trans (B, N, 3)) returns a dict of
    JAX-layout views: 'bev' (B, H, W, C), 'cls_score' / 'bbox_pred' /
    'dir_pred' (B, H, W, A*K), 'depth' / 'depth_logits' (B, N, fH, fW,
    D).  Without the radar stream, ``points`` and ``points_mask`` are
    None.  ``point_dims`` is the dataset's point width (8 for radar).
    """

    def __init__(self, cfg: BEVFusionConfig, point_dims: int = 8):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pc = cfg.pillars
        if cfg.radar_stream:
            self._init_pillars(pc, point_dims)
        self.resnet = ResNet(cfg.resnet_depth, cfg.resnet_out_indices,
                             cfg.frozen_backbone_bn)
        self.fpnc = FPNC(self.resnet.out_channels, 256, cfg.imc,
                         cfg.lss.feat_hw)
        self.lss = LiftSplatShoot(cfg.lss, cfg.imc, cfg.use_depthnet)
        fusion = cfg.radar_stream and cfg.lc_fusion
        self.fuse = (ConvBNReLU(cfg.lss.outC + sum(pc.fpn_channels), cfg.lic)
                     if fusion else None)
        self.se = SEBlock(cfg.lic) if fusion and cfg.se else None
        self.head = Anchor3DHead(cfg.head_channels, pc.num_classes,
                                 pc.num_anchors)

    def forward(self, points, points_mask, imgs, rots, trans):
        pts_bev = None
        if self.cfg.radar_stream:
            if points is None:
                raise ValueError('the radar stream needs points')
            pts_bev = self.pillar_bev(points, points_mask)

        b, n = imgs.shape[:2]
        # NHWC images viewed as NCHW: channels_last memory, no copy.
        flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
        feat = self.fpnc(self.resnet(flat.to(self.head.conv_cls.weight.dtype)))
        cam_bev, depth, depth_logits = self.lss(feat, rots, trans)
        if pts_bev is not None and cam_bev.shape[-2:] != pts_bev.shape[-2:]:
            raise NotImplementedError(
                f'camera BEV {tuple(cam_bev.shape[-2:])} != radar BEV '
                f'{tuple(pts_bev.shape[-2:])}: the resize is not ported')

        if self.fuse is not None:
            fused = self.fuse(torch.cat([cam_bev, pts_bev], dim=1))
            if self.se is not None:
                fused = self.se(fused)
        else:
            fused = cam_bev if pts_bev is None else pts_bev
        out = self.head.outputs(fused)
        out.update(depth=depth, depth_logits=depth_logits)
        return out


def depth_dist_loss(pred_depth, gt_gaussian, gt_min_depth,
                    camera_depth_range: Tuple[float, float, float],
                    method: str = 'kld'):
    """Depth distribution loss (reference ``depth_dist_loss``), in the
    dtype of ``pred_depth`` and ``gt_gaussian``.

    pred_depth (..., D) softmax depth distributions; gt_gaussian (..., D)
    target distributions; gt_min_depth (...) per-pixel min depth (0 = no
    observation).  Averaged over the pixels whose min depth lies in the
    camera's depth range.
    """
    pred, gt = pred_depth, gt_gaussian
    mask = ((gt_min_depth >= camera_depth_range[0])
            & (gt_min_depth <= camera_depth_range[1]))
    denom = mask.sum().clamp(min=1)
    if method == 'kld':
        # F.kl_div(log(pred + 1e-4), target, 'batchmean').
        per = (gt * (torch.log(gt.clamp(min=1e-12))
                     - torch.log(pred + 1e-4))).sum(-1)
    elif method == 'mse':
        per = ((pred - gt) ** 2).mean(-1)
    else:
        raise NotImplementedError(method)
    return torch.where(mask, per, 0.0).sum() / denom
