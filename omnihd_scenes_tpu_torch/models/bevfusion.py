"""BEVFusion camera + 4D-radar detector (counterpart of
``omnihd_scenes_tpu/models/bevfusion.py``), and its depth loss.

radar: voxelize -> PillarFeatureNet -> scatter (``pillar_impl='sorted'``,
the configuration that trains) or DensePillarEncoder (``'dense'``, the
serving configuration; ``'dense_fold'`` folds its frozen BN in eval mode)
-> SECOND -> SECONDFPN -> (B, 384, 160, 240); camera: ResNet (on
space-to-depth packed images with ``stem_s2d``) -> FPNC -> LiftSplatShoot
(DepthNet, the sampling or the scatter splat) -> (B, 256, 160, 240);
fusion: concat -> 3x3 ConvBNReLU (``rc_fusion='concat'``) or RCFusion's
:class:`CrossModalFusion` (``'cross_attention'``) -> SE gate ->
Anchor3DHead (none with ``with_head=False``, the trunk of
``models/mtl.py``'s task-trunk modes).  Without the radar stream
(``configs/lss_camera.py``, the LSS camera-only model) the head reads the
camera BEV directly, as in JAX; without the camera stream
(``camera_stream=False``: no ResNet, FPNC or LSS) or with both but
``lc_fusion=False`` it reads the radar BEV.  ``model.train()`` is the JAX
``train=True``: batch statistics in every BatchNorm but the frozen
backbone's.  ``remat`` rematerialises each trunk of ``('second',
'secondfpn', 'resnet', 'fpnc', 'lss')`` not in ``remat_exclude`` in the
backward (``models/layers.py:remat``), as JAX's ``nn.remat`` does.
Each trunk is the span ``bevfusion.<trunk>``, the pillar canvas
``bevfusion.pillars`` and fusion + SE + head ``bevfusion.fuse_head``
(``utils/timing.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import BEVFusionConfig
from omnihd_scenes_tpu_torch.models.anchor_head import Anchor3DHead
from omnihd_scenes_tpu_torch.models.detectors import PillarBackbone
from omnihd_scenes_tpu_torch.models.fpnc import FPNC, resize_bilinear
from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU, SEBlock, remat
from omnihd_scenes_tpu_torch.models.lss import LiftSplatShoot
from omnihd_scenes_tpu_torch.models.resnet import ResNet
from omnihd_scenes_tpu_torch.parallel import mesh as dp
from omnihd_scenes_tpu_torch.utils.timing import span

TRUNK_SPANS = {name: span(f'bevfusion.{name}') for name in (
    'second', 'secondfpn', 'resnet', 'fpnc', 'lss')}


def check_supported(cfg: BEVFusionConfig) -> None:
    """Raise for an ``rc_fusion`` that is neither fuser (the JAX model
    would run the concat fuser for it)."""
    if cfg.rc_fusion not in ('concat', 'cross_attention'):
        raise NotImplementedError(
            f'not ported yet: rc_fusion={cfg.rc_fusion!r}')


class CrossModalFusion(nn.Module):
    """RCFusion's spatial-attention swap fuser (reference
    ``rcfusion/detectors/BEVCross_modal_attention.py:6-43``): each modality
    is gated by the sigmoid of a bias-free 3x3 conv over the other's
    channel mean and max, then concat + 3x3 ConvBNReLU."""

    def __init__(self, img_channels: int, radar_channels: int,
                 out_channels: int = 384, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.att_img = nn.Conv2d(2, 1, kernel_size, padding=pad, bias=False)
        self.att_radar = nn.Conv2d(2, 1, kernel_size, padding=pad,
                                   bias=False)
        self.fuse = ConvBNReLU(img_channels + radar_channels, out_channels)

    @staticmethod
    def _attention(conv, x):
        pooled = torch.cat([x.mean(1, keepdim=True),
                            x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(conv(pooled))

    def forward(self, img_bev, radar_bev):
        img_att = self._attention(self.att_img, img_bev)
        radar_att = self._attention(self.att_radar, radar_bev)
        return self.fuse(torch.cat([img_bev * radar_att,
                                    radar_bev * img_att], 1))


class BEVFusion(PillarBackbone):
    """Fusion detector over padded inputs.

    forward(points (B, P, point_dims), points_mask (B, P), imgs (B, N, H,
    W, 3), rots (B, N, 3, 3), trans (B, N, 3)) returns a dict of
    JAX-layout views: 'bev' (B, H, W, C), 'cls_score' / 'bbox_pred' /
    'dir_pred' (B, H, W, A*K), 'depth' / 'depth_logits' (B, N, fH, fW,
    D).  With ``with_head=False`` the head maps are None.  Without the
    radar stream, ``points`` and ``points_mask`` are None; without the
    camera stream, ``imgs``, ``rots`` and ``trans`` are, and so are the
    depth maps.  With ``stem_s2d`` the images come packed by
    :func:`~omnihd_scenes_tpu_torch.models.resnet.space_to_depth`, (B, N,
    H/2, W/2, 12).  ``point_dims`` is the dataset's point width (8 for
    radar).
    """

    def __init__(self, cfg: BEVFusionConfig, point_dims: int = 8):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pc = cfg.pillars
        if cfg.radar_stream:
            self._init_pillars(pc, point_dims)
        if cfg.camera_stream:
            self.resnet = ResNet(cfg.resnet_depth, cfg.resnet_out_indices,
                                 cfg.frozen_backbone_bn,
                                 stem_s2d=cfg.stem_s2d)
            self.fpnc = FPNC(self.resnet.out_channels, 256, cfg.imc,
                             cfg.lss.feat_hw)
            self.lss = LiftSplatShoot(cfg.lss, cfg.imc, cfg.use_depthnet)
        fusion = cfg.radar_stream and cfg.camera_stream and cfg.lc_fusion
        self.fuse = None
        if fusion and cfg.rc_fusion == 'cross_attention':
            self.fuse = CrossModalFusion(cfg.lss.outC, sum(pc.fpn_channels),
                                         cfg.lic)
        elif fusion:
            self.fuse = ConvBNReLU(cfg.lss.outC + sum(pc.fpn_channels),
                                   cfg.lic)
        self.se = SEBlock(cfg.lic) if fusion and cfg.se else None
        self.head = (Anchor3DHead(cfg.head_channels, pc.num_classes,
                                  pc.num_anchors) if cfg.with_head else None)

    def _trunk(self, name: str, module: nn.Module, *args):
        """``module(*args)``, rematerialised in the backward when
        ``remat`` is on, ``name`` is not in ``remat_exclude`` and a
        gradient is being recorded."""
        cfg = self.cfg
        with TRUNK_SPANS[name]:
            if (cfg.remat and name not in cfg.remat_exclude
                    and torch.is_grad_enabled()):
                return remat(module, *args)
            return module(*args)

    def forward(self, points, points_mask, imgs, rots, trans):
        cfg = self.cfg
        pts_bev = cam_bev = depth = depth_logits = None
        if cfg.radar_stream:
            if points is None:
                raise ValueError('the radar stream needs points')
            with span('bevfusion.pillars'):
                canvas = self.pillar_canvas(points, points_mask)
            pts_bev = self._trunk('secondfpn', self.second_fpn,
                                  self._trunk('second', self.second, canvas))

        if cfg.camera_stream:
            b, n = imgs.shape[:2]
            # NHWC images viewed as NCHW: channels_last memory, no copy.
            flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
            stages = self._trunk('resnet', self.resnet,
                                 flat.to(self.resnet.conv1.weight.dtype))
            feat = self._trunk('fpnc', self.fpnc, stages)
            cam_bev, depth, depth_logits = self._trunk('lss', self.lss, feat,
                                                       rots, trans)

        with span('bevfusion.fuse_head'):
            if cam_bev is not None and pts_bev is not None:
                # The LSS grid is (ny, nx), y-major like the pillar FPN
                # output; resized when the resolutions differ.
                cam_bev = resize_bilinear(cam_bev, pts_bev.shape[-2:])
            if isinstance(self.fuse, CrossModalFusion):
                fused = self.fuse(cam_bev, pts_bev)
            elif self.fuse is not None:
                fused = self.fuse(torch.cat([cam_bev, pts_bev], dim=1))
            else:
                fused = cam_bev if pts_bev is None else pts_bev
            if self.se is not None:
                fused = self.se(fused)
            if self.head is not None:
                out = self.head.outputs(fused)
            else:
                out = {'cls_score': None, 'bbox_pred': None,
                       'dir_pred': None, 'bev': fused.permute(0, 2, 3, 1)}
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

    With a data-parallel group of W > 1 ranks (``parallel/mesh.py:
    sync_group``) the pixels are those of the global batch, as in JAX: the
    denominator is the mask count summed over the ranks, and each rank's
    sum is scaled by W, so that the mean of the ranks' losses (and of
    their gradients) is the global loss (and its gradient).
    """
    pred, gt = pred_depth, gt_gaussian
    mask = ((gt_min_depth >= camera_depth_range[0])
            & (gt_min_depth <= camera_depth_range[1]))
    count = mask.sum()
    group = dp.sync_group()
    if group is not None:
        torch.distributed.all_reduce(count, group=group)
    denom = count.clamp(min=1)
    if method == 'kld':
        # F.kl_div(log(pred + 1e-4), target, 'batchmean').
        per = (gt * (torch.log(gt.clamp(min=1e-12))
                     - torch.log(pred + 1e-4))).sum(-1)
    elif method == 'mse':
        per = ((pred - gt) ** 2).mean(-1)
    else:
        raise NotImplementedError(method)
    loss = torch.where(mask, per, 0.0).sum() / denom
    return loss if group is None else loss * dp.data_parallel_size()
