"""Lift-Splat-Shoot camera view transform (counterpart of
``omnihd_scenes_tpu/models/lss.py``), sampling mode.

Camera features (B*N, C, fH, fW) -> DepthNet (or the 1x1 CamEncode) ->
depth-weighted sampling into the (nz, ny, nx) grid (the LSS kernel) ->
z collapsed into channels -> BEV conv stack.  The splat returns
(B, ny, nx, nz, C), so the z-collapse to channels_last
(B, nz*C, ny, nx) is a free view.  ``splat_mode='scatter'`` is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.config import LSSConfig
from omnihd_scenes_tpu_torch.models.layers import (FLAX_BN_EPS, BatchNorm,
                                                 ConvBNReLU)
from omnihd_scenes_tpu_torch.models.quant import QConv2d
from omnihd_scenes_tpu_torch.models.resnet import BasicBlock
from omnihd_scenes_tpu_torch.ops.lss_project import lss_sample_bev


class CamEncode(nn.Module):
    """1x1 conv -> (C context features, D softmax depth)."""

    def __init__(self, in_channels: int, depth_bins: int, cam_channels: int):
        super().__init__()
        self.depth_bins = depth_bins
        self.conv = nn.Conv2d(in_channels, depth_bins + cam_channels, 1)

    def forward(self, x):
        x = self.conv(x)
        depth = torch.softmax(x[:, :self.depth_bins], dim=1)
        return x[:, self.depth_bins:], depth


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 branches (6/12/18) + global-average
    branch, concatenated and reduced 1x1."""

    DILATIONS = (1, 6, 12, 18)

    def __init__(self, in_channels: int, mid_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([
            QConv2d(in_channels, mid_channels, 1 if d == 1 else 3,
                    padding=0 if d == 1 else d, dilation=d, bias=False)
            for d in self.DILATIONS])
        self.bns = nn.ModuleList([BatchNorm(mid_channels, FLAX_BN_EPS)
                                  for _ in self.DILATIONS])
        self.pool_conv = QConv2d(in_channels, mid_channels, 1, bias=False)
        self.pool_bn = BatchNorm(mid_channels, FLAX_BN_EPS)
        self.project = QConv2d(mid_channels * 5, mid_channels, 1,
                               bias=False)
        self.project_bn = BatchNorm(mid_channels, FLAX_BN_EPS)

    def forward(self, x):
        branches = [F.relu(bn(conv(x))) for conv, bn in zip(self.convs,
                                                             self.bns)]
        g = F.relu(self.pool_bn(self.pool_conv(x.mean(dim=(2, 3),
                                                      keepdim=True))))
        branches.append(g.expand(-1, -1, *x.shape[-2:]))
        return F.relu(self.project_bn(self.project(torch.cat(branches, 1))))


class DepthNet(nn.Module):
    """BEVDepth-style depth head as the JAX ``DepthNet`` builds it inside
    LiftSplatShoot: mid = in channels, ASPP on, no DCN."""

    def __init__(self, in_channels: int, depth_bins: int, cam_channels: int):
        super().__init__()
        mid = in_channels
        self.reduce = ConvBNReLU(in_channels, mid, 3)
        self.context_conv = nn.Conv2d(mid, cam_channels, 1)
        self.blocks = nn.Sequential(*[BasicBlock(mid, mid) for _ in range(3)])
        self.aspp = ASPP(mid, mid)
        self.depth_conv = nn.Conv2d(mid, depth_bins, 1)

    def forward(self, x):
        x = self.reduce(x)
        ctx = self.context_conv(x)
        logits = self.depth_conv(self.aspp(self.blocks(x)))
        return ctx, torch.softmax(logits, dim=1), logits


class BevEncoderConvs(nn.Module):
    """Z-collapsed BEV conv stack: cz -> cz -> 512 -> 512 -> outC."""

    def __init__(self, in_channels: int, outC: int = 256):
        super().__init__()
        chs = (in_channels, in_channels, 512, 512, outC)
        self.layers = nn.Sequential(*[ConvBNReLU(chs[i], chs[i + 1], 3)
                                      for i in range(4)])

    def forward(self, x):
        return self.layers(x)


def _nhwc(x, b, n):
    """(B*N, C, H, W) -> contiguous (B, N, H, W, C)."""
    x = x.permute(0, 2, 3, 1).contiguous()
    return x.view(b, n, *x.shape[1:])


class LiftSplatShoot(nn.Module):
    """Camera features + geometry -> (B, outC, ny, nx) BEV features
    (y-major, like the pillar canvas) + depth distributions."""

    def __init__(self, cfg: LSSConfig, in_channels: int,
                 use_depthnet: bool = True):
        super().__init__()
        if cfg.splat_mode != 'sample':
            raise NotImplementedError(
                f"splat_mode={cfg.splat_mode!r}: only 'sample' is ported")
        self.cfg = cfg
        self.use_depthnet = use_depthnet
        if use_depthnet:
            self.depthnet = DepthNet(in_channels, cfg.depth_bins, cfg.camC)
        else:
            self.cam_encode = CamEncode(in_channels, cfg.depth_bins, cfg.camC)
        self.bev_encoder = BevEncoderConvs(cfg.bev_nx[2] * cfg.camC, cfg.outC)

    def forward(self, cam_feats, rots, trans):
        """cam_feats (B*N, C, fH, fW); rots (B, N, 3, 3), trans (B, N, 3).

        Returns bev (B, outC, ny, nx), depth (B, N, fH, fW, D) and depth
        logits (B, N, fH, fW, D) (None without DepthNet).
        """
        b, n_view = rots.shape[:2]
        if self.use_depthnet:
            feat, depth, logits = self.depthnet(cam_feats)
            logits = _nhwc(logits, b, n_view)
        else:
            (feat, depth), logits = self.cam_encode(cam_feats), None
        depth = _nhwc(depth, b, n_view)
        bev = self.view_transform(depth, _nhwc(feat, b, n_view), rots, trans)
        return self.bev_encoder(bev), depth, logits

    def view_transform(self, depth, feat, rots, trans):
        """depth (B, N, fH, fW, D), feat (B, N, fH, fW, C) -> the
        z-collapsed grid (B, nz * C, ny, nx), channels_last (a view of the
        LSS kernel's (B, ny, nx, nz, C) result)."""
        cfg = self.cfg
        b, n_view = rots.shape[:2]
        nx, ny, nz = cfg.bev_nx
        solve_x = (cfg.cam_solve_x + (True,) * n_view)[:n_view]
        vox = lss_sample_bev(
            depth, feat, rots, trans,
            image_size=cfg.final_dim, depth_range=cfg.camera_depth_range,
            bev_start=cfg.pc_range[:3], bev_voxel=(cfg.grid,) * 3,
            bev_nx=(nx, ny, nz), solve_x=solve_x)     # (B, nz, ny, nx, C)
        bev = vox.permute(0, 2, 3, 1, 4).reshape(b, ny, nx, nz * cfg.camC)
        return bev.permute(0, 3, 1, 2)
