"""Plain float32 reference of BEVFusion (camera + 4D radar): radar
pillars (dense, as served, or voxelized and sorted, as trained) ->
SECOND -> SECONDFPN; ResNet -> FPNC -> DepthNet (+ ASPP) -> the LSS
sampling view transform as a plain gather -> the BEV conv stack; concat
fusion -> SE -> anchor head; then box decode and the rotated multi-class
NMS, or the training losses (target assignment, focal, smooth L1,
direction and depth terms).

A frozen copy of the port's modules at the time the benchmark was defined
(``models/bevfusion.py``, ``lss.py``, ``pillar_encoders.py``,
``second.py``, ``anchor_head.py``, ``target_assign.py``, ``losses.py``,
``ops/boxes3d.py``, ``ops/nms.py``, ``ops/voxelize.py`` and the plain
index fields and gather of ``kernels/lss_sample.py``), reduced to the
paths of ``perfbench/configs/bevfusion.json``: plain convs, the view
transform computed in float32 by indexing where the port launches its
CUDA kernel (autograd differentiates the indexing for training).
Module and parameter names are the port's, so one state dict loads into
both.  Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.common import (BN_EPS, FLAX_BN_EPS, BasicBlock,
                                        BatchNorm, ConvBNReLU, DeconvBNReLU,
                                        FPNC, ResNet, SEBlock,
                                        resize_bilinear)


# ---- the view transform's index fields and gather (kernels/lss_sample.py) ---

_BIG = 1e9


def _safe_div(a, b, eps=1e-6):
    bs = torch.where(b.abs() < eps,
                     torch.where(b < 0, -eps, eps).to(b.dtype), b)
    return a / bs


def _clean_idx(x, valid):
    """Round a float index to int32, routing invalid/non-finite entries
    to -1."""
    ok = valid & torch.isfinite(x)
    x = torch.where(ok, x, -_BIG)
    return torch.round(x).clamp(-1, _BIG).to(torch.int32)


class _Geom:
    """Static geometry of the image plane and the BEV grid (NumPy f32,
    built exactly as the JAX ``_Geom``)."""

    def __init__(self, image_size, feat_hw, depth_range, bev_start,
                 bev_voxel, bev_nx):
        self.args = tuple(tuple(a) for a in (
            image_size, feat_hw, depth_range, bev_start, bev_voxel, bev_nx))
        self.h_img, self.w_img = image_size
        self.f_h, self.f_w = feat_hw
        self.d0, self.d1, self.dd = depth_range
        self.nx, self.ny, self.nz = (int(v) for v in bev_nx)
        self.v_scale = (self.f_h - 1) / max(self.h_img - 1, 1)
        self.u_scale = (self.f_w - 1) / max(self.w_img - 1, 1)
        self.ys = np.linspace(0, self.h_img - 1, self.f_h, dtype=np.float32)
        self.xc = np.asarray(
            bev_start[0]
            + (np.arange(self.nx, dtype=np.float32) + 0.5) * bev_voxel[0],
            np.float32)
        self.yc = np.asarray(
            bev_start[1]
            + (np.arange(self.ny, dtype=np.float32) + 0.5) * bev_voxel[1],
            np.float32)
        self.zc = np.asarray(
            bev_start[2]
            + (np.arange(self.nz, dtype=np.float32) + 0.5) * bev_voxel[2],
            np.float32)


def _sample_indices(minv, mt, solve_axis_x: bool, g: _Geom):
    """Index fields of cameras that share one orientation.

    ``minv`` (..., 3, 3) and ``mt`` (..., 3) f32, any leading dims.
    Returns, in the JAX layout with the leading dims in front:
        i_star (..., fH, nz, n_b), j_star and kd_star (..., nz, n_b, n_g),
    int32, -1 where invalid.  (n_b, n_g) = (ny, nx) when
    ``solve_axis_x`` else (nx, ny).
    """
    dev = minv.device

    def const(a):
        return torch.from_numpy(a).to(dev)

    if solve_axis_x:
        a_col, bc, gc, fixed = minv[..., 0], g.yc, g.xc, minv[..., 1]
    else:
        a_col, bc, gc, fixed = minv[..., 1], g.xc, g.yc, minv[..., 0]
    bc, gc, zc, ys = const(bc), const(gc), const(g.zc), const(g.ys)
    # cc[..., a, k, b] = fixed_a * bc_b + Minv[a, 2] * zc_k + mt_a
    cc = (fixed[..., None, None] * bc
          + minv[..., 2][..., None, None] * zc[:, None]
          + mt[..., None, None])                         # (..., 3, nz, n_b)
    d_floor = max(1e-3, g.d0 * 0.5)

    def coef(a):                                         # (..., 1, 1, 1)
        return a_col[..., a, None, None, None]

    # pass 1: solve q1/q2 = v_j for the free coordinate s
    v = ys[:, None, None]                                # (fH, 1, 1)
    denom = coef(1) - v * coef(2)
    c0, c1, c2 = (cc[..., a, None, :, :] for a in range(3))
    s_star = _safe_div(v * c2 - c1, denom)               # (..., fH, nz, n_b)
    q2s = coef(2) * s_star + c2
    us = _safe_div(coef(0) * s_star + c0, q2s)
    ok1 = (q2s > d_floor) & (us > -0.5) & (us < g.w_img - 0.5)
    i_star = _clean_idx(us * g.u_scale, ok1)

    # pass 2: full projection at output cell (k, b, g)
    # (..., 3, nz, n_b, n_g)
    qf = a_col[..., None, None, None] * gc + cc[..., None]
    d_star = qf[..., 2, :, :, :]
    vs = _safe_div(qf[..., 1, :, :, :], d_star)
    ok2 = (d_star > d_floor) & (vs > -0.5) & (vs < g.h_img - 0.5)
    j_star = _clean_idx(vs * g.v_scale, ok2)
    kd_star = _clean_idx((d_star - g.d0) / g.dd, ok2)
    return i_star, j_star, kd_star


class SampleFields(NamedTuple):
    """Index fields of a batch in the fields-in kernel's layout."""
    i_star: torch.Tensor    # (B, N, fH, nz, max(nx, ny)) int32
    j_star: torch.Tensor    # (B, N, nz, ny * nx) int32
    kd_star: torch.Tensor   # (B, N, nz, ny * nx) int32


def pack_fields(per_camera, g: _Geom) -> SampleFields:
    """Pack per-camera JAX-layout fields ``[(i, j, kd), ...]`` (each with
    the batch dim in front) into the kernel's layout."""
    i0 = per_camera[0][0]
    b, n_cams = i0.shape[0], len(per_camera)
    i_all = torch.full((b, n_cams, g.f_h, g.nz, max(g.nx, g.ny)), -1,
                       dtype=torch.int32, device=i0.device)
    for n, (i, _, _) in enumerate(per_camera):
        i_all[:, n, ..., :i.shape[-1]] = i
    j_all = torch.stack([j.flatten(-2) for _, j, _ in per_camera], 1)
    kd_all = torch.stack([kd.flatten(-2) for _, _, kd in per_camera], 1)
    return SampleFields(i_all, j_all.contiguous(), kd_all.contiguous())


def geometry_fields(minv, mt, g: _Geom,
                    solve_x: Sequence[bool]) -> SampleFields:
    """Index fields of a batch: minv (B, N, 3, 3), mt (B, N, 3) f32."""
    per_camera = [None] * len(solve_x)
    for sx in (True, False):
        cams = [n for n, s in enumerate(solve_x) if bool(s) == sx]
        if not cams:
            continue
        i, j, kd = _sample_indices(minv[:, cams], mt[:, cams], sx, g)
        for k, n in enumerate(cams):
            per_camera[n] = (i[:, k], j[:, k], kd[:, k])
    return pack_fields(per_camera, g)


def _camera_cells(i_star, j_star, kd_star, solve_x, ny, nx, d_bins):
    """Per camera n, over the (B, ny, nx, nz) output cells: the cell's
    row and depth bin, the column read at that row (-1 where row or bin is
    out of range: the word is not read), the word's flat index in
    ``i_star[b, n]`` (row clamped) and whether it is read."""
    b, _, f_h, nz, nb = i_star.shape
    dev = i_star.device
    y = torch.arange(ny, device=dev).view(ny, 1, 1)
    x = torch.arange(nx, device=dev).view(1, nx, 1)
    z = torch.arange(nz, device=dev).view(1, 1, nz)
    bb = torch.arange(b, device=dev).view(b, 1, 1, 1)
    for n, sx in enumerate(solve_x):
        col, bg = (y, y * nx + x) if sx else (x, x * ny + y)
        cell = z * (ny * nx) + bg                         # (ny, nx, nz)
        j = j_star[:, n].flatten(1)[:, cell]              # (B, ny, nx, nz)
        kd = kd_star[:, n].flatten(1)[:, cell]
        read_i = (j >= 0) & (j < f_h) & (kd >= 0) & (kd < d_bins)
        word = (j.clamp(0, f_h - 1) * nz + z) * nb + col
        i = torch.where(read_i, i_star[:, n].flatten(1)[bb, word], -1)
        yield n, j, i, kd, word, read_i


def cell_indices(i_star, j_star, kd_star, solve_x: Sequence[bool], ny: int,
                 nx: int, d_bins: int):
    """(j, i, kd), each (B, ny, nx, nz, N) int32: what every cell uses per
    camera (the layout of the kernel's index dump)."""
    cams = list(_camera_cells(i_star, j_star, kd_star, solve_x, ny, nx,
                              d_bins))
    return tuple(torch.stack([c[k] for c in cams], -1) for k in (1, 2, 3))


def gather_cells(feat, depth, j, i, kd, out_dtype: torch.dtype):
    """Plain gather-multiply-sum on per-cell indices (B, ny, nx, nz, N):
    in f32, with the cameras summed in order; a camera adds nothing where
    j, i or kd is out of range."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    acc = torch.zeros(j.shape[:4] + (c_ch,), dtype=torch.float32,
                      device=feat.device)
    for n in range(n_cams):
        jn, i_n, kn = j[..., n], i[..., n], kd[..., n]
        ok = ((jn >= 0) & (jn < f_h) & (i_n >= 0) & (i_n < f_w) & (kn >= 0)
              & (kn < d_bins))
        jc, ic = jn.clamp(0, f_h - 1), i_n.clamp(0, f_w - 1)
        w = depth[bb, n, jc, ic, kn.clamp(0, d_bins - 1)].float() * ok
        acc += feat[bb, n, jc, ic].float() * w[..., None]
    return acc.to(out_dtype)


# ---- configuration ----------------------------------------------------------

class DecodeCfg(NamedTuple):
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_thr: float = 0.2
    max_num: int = 500
    dir_offset: float = 0.7854
    dir_limit_offset: float = 0.0


def check_supported(model: dict) -> None:
    """Raise for a configuration off the path this reference follows."""
    lss, pillars = model['lss'], model['pillars']
    want = {'camera_stream': True, 'radar_stream': True, 'lc_fusion': True,
            'se': True, 'rc_fusion': 'concat', 'use_depthnet': True,
            'stem_s2d': False, 'with_head': True}
    bad = {k: model[k] for k, v in want.items() if model[k] != v}
    if lss['splat_mode'] != 'sample':
        bad['lss.splat_mode'] = lss['splat_mode']
    if pillars['pillar_impl'] not in ('dense', 'sorted'):
        bad['pillars.pillar_impl'] = pillars['pillar_impl']
    if pillars['with_velocity_snr_center']:
        bad['pillars.with_velocity_snr_center'] = True
    if bad:
        raise NotImplementedError(f'the reference does not follow {bad}')


def feat_hw(lss: dict):
    h, w = lss['final_dim']
    return h // lss['downsample'], w // lss['downsample']


def depth_bins(lss: dict) -> int:
    d0, d1, dd = lss['camera_depth_range']
    return int((d1 - d0) / dd)


def bev_nx(lss: dict):
    """(nx, ny, nz) voxel counts."""
    r, g = lss['pc_range'], lss['grid']
    return tuple(int((r[i + 3] - r[i]) / g) for i in range(3))


def head_hw(pillars: dict):
    s = pillars['second_strides'][0] * pillars['fpn_strides'][0]
    return pillars['bev_hw'][0] // s, pillars['bev_hw'][1] // s


def anchors(pillars: dict) -> np.ndarray:
    """(H, W, A, 9) f32 aligned anchor grid of the head map (mmdet3d's
    ``AlignedAnchor3DRangeGenerator``; sizes major, then rotations)."""
    h, w = head_hw(pillars)
    rotations = pillars['anchor_rotations']
    per_size = []
    for rng, size in zip(pillars['anchor_ranges'], pillars['anchor_sizes']):
        x0, y0, z, x1, y1, _ = rng
        xs = x0 + (np.arange(w) + 0.5) * ((x1 - x0) / w)
        ys = y0 + (np.arange(h) + 0.5) * ((y1 - y0) / h)
        gx, gy = np.meshgrid(xs, ys)
        base = np.zeros((h, w, len(rotations), 9), dtype=np.float32)
        base[..., 0] = gx[..., None]
        base[..., 1] = gy[..., None]
        base[..., 2] = z
        base[..., 3:6] = size
        base[..., 6] = np.asarray(rotations)
        per_size.append(base)
    return np.stack(per_size, axis=2).reshape(h, w, -1, 9)


# ---- radar pillars ----------------------------------------------------------

class PFNLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=False)
        self.bn = BatchNorm(out_features, BN_EPS)

    def forward(self, x):
        y = self.linear(x)
        return F.relu(self.bn(y.reshape(-1, y.shape[-1])).view(y.shape))


class DensePillarEncoder(nn.Module):
    """Points (B, P, D) + mask (B, P) -> BEV canvas (B, C, H, W): every
    point gains its offsets from its pillar's mean xyz and centre, then
    the PFN, then a max over the pillar's points; empty pillars are 0."""

    def __init__(self, in_channels: int, feat_channels, voxel_size,
                 point_cloud_range, grid_hw):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_hw = tuple(grid_hw)
        d_in = in_channels + 5
        layers = []
        for ch in feat_channels:
            layers.append(PFNLayer(d_in, ch))
            d_in = 2 * ch
        self.pfn = nn.ModuleList(layers)

    def forward(self, points, points_mask):
        b, n, d = points.shape
        h, w = self.grid_hw
        hw = h * w
        x0, y0, z0, x1, y1, z1 = self.point_cloud_range
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pts = points.reshape(b * n, d)
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
        lin_g = torch.where(valid, cell, 0)
        stats = torch.where(valid[:, None],
                            torch.cat([torch.ones_like(pts[:, :1]),
                                       pts[:, :3]], -1), 0.0)
        sums = pts.new_zeros((b * hw + 1, 4)).index_add_(0, lin, stats)
        means = sums[:, 1:] / sums[:, :1].clamp(min=1.0)
        cx = ix.to(pts.dtype) * vx + (vx / 2 + x0)
        cy = iy.to(pts.dtype) * vy + (vy / 2 + y0)
        centre = torch.stack([pts[:, 0] - cx, pts[:, 1] - cy], -1)
        x = torch.where(valid[:, None],
                        torch.cat([pts, pts[:, :3] - means[lin_g], centre],
                                  -1), 0.0)
        canvas = None
        for i, layer in enumerate(self.pfn):
            x = layer(x)
            ch = x.shape[-1]
            canvas = x.new_zeros((b * hw + 1, ch)).scatter_reduce_(
                0, lin[:, None].expand(-1, ch), x, 'amax',
                include_self=False)
            if i != len(self.pfn) - 1:
                x = torch.where(valid[:, None],
                                torch.cat([x, canvas[lin_g]], -1), 0.0)
        return canvas[:b * hw].view(b, h, w, -1).permute(0, 3, 1, 2)


class SECOND(nn.Module):
    def __init__(self, in_channels, layer_nums, layer_strides, out_channels):
        super().__init__()
        blocks = []
        for num, stride, ch in zip(layer_nums, layer_strides, out_channels):
            blocks.append(nn.Sequential(
                ConvBNReLU(in_channels, ch, 3, stride=stride),
                *[ConvBNReLU(ch, ch, 3) for _ in range(num)]))
            in_channels = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)


class SECONDFPN(nn.Module):
    def __init__(self, in_channels, upsample_strides, out_channels):
        super().__init__()
        self.deblocks = nn.ModuleList([
            DeconvBNReLU(cin, ch, stride) for cin, stride, ch in
            zip(in_channels, upsample_strides, out_channels)])

    def forward(self, feats):
        ups = [deblock(f) for deblock, f in zip(self.deblocks, feats)]
        min_h = min(u.shape[-2] for u in ups)
        min_w = min(u.shape[-1] for u in ups)
        return torch.cat([u[..., :min_h, :min_w] for u in ups], dim=1)


# ---- camera: DepthNet and the view transform --------------------------------

class ASPP(nn.Module):
    DILATIONS = (1, 6, 12, 18)

    def __init__(self, in_channels: int, mid_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, mid_channels, 1 if d == 1 else 3,
                      padding=0 if d == 1 else d, dilation=d, bias=False)
            for d in self.DILATIONS])
        self.bns = nn.ModuleList([BatchNorm(mid_channels, FLAX_BN_EPS)
                                  for _ in self.DILATIONS])
        self.pool_conv = nn.Conv2d(in_channels, mid_channels, 1, bias=False)
        self.pool_bn = BatchNorm(mid_channels, FLAX_BN_EPS)
        self.project = nn.Conv2d(mid_channels * 5, mid_channels, 1,
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
    def __init__(self, in_channels: int, outC: int = 256):
        super().__init__()
        chs = (in_channels, in_channels, 512, 512, outC)
        self.layers = nn.Sequential(*[ConvBNReLU(chs[i], chs[i + 1], 3)
                                      for i in range(4)])

    def forward(self, x):
        return self.layers(x)


def _nhwc(x, b, n):
    x = x.permute(0, 2, 3, 1).contiguous()
    return x.view(b, n, *x.shape[1:])


def sample_bev(depth, feat, rots, trans, lss: dict):
    """The sampling view transform: for every BEV voxel and camera, the
    feature row times the depth probability at the pixel and bin the
    voxel centre projects to, summed over the cameras, in f32.
    depth (B, N, fH, fW, D), feat (B, N, fH, fW, C), rots / trans the
    img->lidar geometry -> (B, ny, nx, nz, C)."""
    nx, ny, nz = bev_nx(lss)
    n_view = rots.shape[1]
    solve_x = (tuple(lss['cam_solve_x']) + (True,) * n_view)[:n_view]
    g = _Geom(lss['final_dim'], depth.shape[2:4], lss['camera_depth_range'],
              lss['pc_range'][:3], (lss['grid'],) * 3, (nx, ny, nz))
    minv = torch.linalg.inv_ex(rots.float())[0]
    mt = -torch.einsum('...ij,...j->...i', minv, trans.float())
    fields = geometry_fields(minv, mt, g, solve_x)
    idx = cell_indices(*fields, solve_x, ny, nx, depth.shape[-1])
    return gather_cells(feat, depth, *idx, torch.float32)


class LiftSplatShoot(nn.Module):
    def __init__(self, lss: dict, in_channels: int):
        super().__init__()
        self.lss = lss
        self.depthnet = DepthNet(in_channels, depth_bins(lss), lss['camC'])
        self.bev_encoder = BevEncoderConvs(bev_nx(lss)[2] * lss['camC'],
                                           lss['outC'])

    def forward(self, cam_feats, rots, trans):
        b, n_view = rots.shape[:2]
        feat, depth, logits = self.depthnet(cam_feats)
        depth, logits = _nhwc(depth, b, n_view), _nhwc(logits, b, n_view)
        vox = sample_bev(depth, _nhwc(feat, b, n_view), rots, trans,
                         self.lss)                   # (B, ny, nx, nz, C)
        bev = vox.reshape(*vox.shape[:3], -1).permute(0, 3, 1, 2)
        return self.bev_encoder(bev), depth, logits


# ---- fusion and head --------------------------------------------------------

class Anchor3DHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 code_size: int = 9):
        super().__init__()
        self.conv_cls = nn.Conv2d(in_channels, num_anchors * num_classes, 1)
        self.conv_reg = nn.Conv2d(in_channels, num_anchors * code_size, 1)
        self.conv_dir = nn.Conv2d(in_channels, num_anchors * 2, 1)

    def forward(self, x):
        return self.conv_cls(x), self.conv_reg(x), self.conv_dir(x)


class BEVFusion(nn.Module):
    """forward(points (B, P, 8), points_mask (B, P), imgs (B, N, H, W, 3),
    rots (B, N, 3, 3), trans (B, N, 3)) -> dict of (B, H, W, ...) maps:
    'cls_score', 'bbox_pred', 'dir_pred', 'bev', and 'depth' /
    'depth_logits' (B, N, fH, fW, D)."""

    def __init__(self, model: dict, point_dims: int = 8):
        super().__init__()
        check_supported(model)
        self.cfg = model
        pc, lss = model['pillars'], model['lss']
        if pc['pillar_impl'] == 'dense':
            self.pillar_encoder = DensePillarEncoder(
                point_dims, pc['pfn_channels'], pc['voxel_size'],
                pc['point_cloud_range'], pc['bev_hw'])
        else:
            self.pillar_encoder = PillarFeatureNet(
                point_dims, pc['pfn_channels'], pc['voxel_size'],
                pc['point_cloud_range'])
        self.second = SECOND(pc['pfn_channels'][-1], pc['second_layer_nums'],
                             pc['second_strides'], pc['second_channels'])
        self.second_fpn = SECONDFPN(pc['second_channels'], pc['fpn_strides'],
                                    pc['fpn_channels'])
        self.resnet = ResNet(model['resnet_depth'],
                             model['resnet_out_indices'],
                             model['frozen_backbone_bn'])
        self.fpnc = FPNC(self.resnet.out_channels, 256, model['imc'],
                         feat_hw(lss))
        self.lss = LiftSplatShoot(lss, model['imc'])
        self.fuse = ConvBNReLU(lss['outC'] + sum(pc['fpn_channels']),
                               model['lic'])
        self.se = SEBlock(model['lic'])
        n_anchors = len(pc['anchor_sizes']) * len(pc['anchor_rotations'])
        self.head = Anchor3DHead(model['lic'], pc['num_classes'], n_anchors)

    def pillar_canvas(self, points, points_mask):
        pc = self.cfg['pillars']
        if pc['pillar_impl'] == 'dense':
            return self.pillar_encoder(points, points_mask)
        vox = voxelize(points, points_mask, pc['point_cloud_range'],
                       pc['voxel_size'], pc['max_voxels'],
                       pc['max_points_per_voxel'])
        pf = self.pillar_encoder(vox.features, vox.num_points, vox.coords)
        return scatter_to_bev(pf, vox.coords, vox.valid, pc['bev_hw'])

    def forward(self, points, points_mask, imgs, rots, trans):
        pts_bev = self.second_fpn(self.second(self.pillar_canvas(
            points, points_mask)))
        b, n = imgs.shape[:2]
        flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
        cam_bev, depth, logits = self.lss(self.fpnc(self.resnet(flat)), rots,
                                          trans)
        cam_bev = resize_bilinear(cam_bev, pts_bev.shape[-2:])
        fused = self.se(self.fuse(torch.cat([cam_bev, pts_bev], dim=1)))
        names = ('cls_score', 'bbox_pred', 'dir_pred', 'bev')
        out = {k: t.permute(0, 2, 3, 1)
               for k, t in zip(names, (*self.head(fused), fused))}
        out.update(depth=depth, depth_logits=logits)
        return out


def build(model: dict) -> BEVFusion:
    return BEVFusion(model)


# ---- decode and rotated NMS (anchor_head.py, ops/boxes3d.py, ops/nms.py) ----

def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val * (1.0 / period) + offset) * period


def bev_corners(boxes):
    """(..., 4, 2) BEV polygon corners (counter-clockwise)."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    hw, hl = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    yaw = boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([hw, -hw, -hw, hw], dim=-1)
    ly = torch.stack([hl, hl, -hl, -hl], dim=-1)
    gx = cx[..., None] + lx * cos[..., None] - ly * sin[..., None]
    gy = cy[..., None] + lx * sin[..., None] + ly * cos[..., None]
    return torch.stack([gx, gy], dim=-1)


def _edge_clip_cross(p0, r, boxes, eps_in=1e-5, eps_b=1e-5, eps_par=1e-6):
    """Green's-theorem boundary term of directed edges ``p0 + t*r``
    (t in [0, 1]) clipped to rotated boxes; boundary-coincident pieces
    weigh 1/2 (see the JAX docstring for why)."""
    cx, cy, yaw = boxes[..., 0], boxes[..., 1], boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    dx, dy = p0[..., 0] - cx, p0[..., 1] - cy
    al = torch.stack([cos * dx + sin * dy, -sin * dx + cos * dy], -1)
    rl = torch.stack([cos * r[..., 0] + sin * r[..., 1],
                      -sin * r[..., 0] + cos * r[..., 1]], -1)
    h = torch.stack([boxes[..., 3], boxes[..., 4]], -1) * 0.5

    scale = (1.0 + p0[..., 0].abs() + p0[..., 1].abs()
             + r[..., 0].abs() + r[..., 1].abs())[..., None]
    parallel = rl.abs() < eps_par * scale
    safe_rl = torch.where(parallel, torch.ones_like(rl), rl)
    ta = (-h - eps_in - al) / safe_rl
    tb = (h + eps_in - al) / safe_rl
    inside = al.abs() <= h + eps_in
    big = torch.full_like(al, 1e30)
    tmin = torch.where(parallel, torch.where(inside, -big, big),
                       torch.minimum(ta, tb))
    tmax = torch.where(parallel, torch.where(inside, big, -big),
                       torch.maximum(ta, tb))
    t0 = tmin.amax(-1).clamp(min=0.0)
    t1 = tmax.amin(-1).clamp(max=1.0)
    empty = t1 < t0
    t0 = torch.where(empty, torch.zeros_like(t0), t0)
    t1 = torch.where(empty, torch.zeros_like(t1), t1)

    pa = p0 + t0[..., None] * r
    pb = p0 + t1[..., None] * r
    on_boundary = (parallel & ((al.abs() - h).abs() <= eps_b)).any(-1)
    w = torch.where(on_boundary, 0.5, 1.0).to(pa.dtype)
    return w * (pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0])


def rotated_intersection_bev(boxes1, boxes2):
    """Exact pairwise rotated BEV intersection areas (..., N, M)."""
    c1, c2 = bev_corners(boxes1), bev_corners(boxes2)     # (..., N, 4, 2)
    r1 = c1.roll(-1, dims=-2) - c1                        # CCW edges
    r2 = c2.roll(-1, dims=-2) - c2
    s1 = _edge_clip_cross(c1[..., :, None, :, :], r1[..., :, None, :, :],
                          boxes2[..., None, :, None, :])
    s2 = _edge_clip_cross(c2[..., None, :, :, :], r2[..., None, :, :, :],
                          boxes1[..., :, None, None, :])
    inter = 0.5 * (s1.sum(-1) + s2.sum(-1))
    area1 = (boxes1[..., 3] * boxes1[..., 4])[..., :, None]
    area2 = (boxes2[..., 3] * boxes2[..., 4])[..., None, :]
    return torch.minimum(inter.clamp(min=0.0), torch.minimum(area1, area2))


def rotated_iou_bev(boxes1, boxes2, eps: float = 1e-6):
    """Exact pairwise rotated BEV IoU (..., N, M)."""
    inter = rotated_intersection_bev(boxes1, boxes2)
    area1 = (boxes1[..., 3] * boxes1[..., 4])[..., :, None]
    area2 = (boxes2[..., 3] * boxes2[..., 4])[..., None, :]
    return inter / (area1 + area2 - inter).clamp(min=eps)


def decode_boxes(anchors, deltas):
    """DeltaXYZWLHR decode (code size 9), inverse of the JAX
    ``encode_boxes``."""
    xa, ya, za, wa, la, ha, ra, vxa, vya = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt, vxt, vyt = deltas.unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la * la + wa * wa)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    vxg = vxt * diag + vxa
    vyg = vyt * diag + vya
    return torch.stack([xg, yg, zg, wg, lg, hg, rg, vxg, vyg], dim=-1)



def _rows(table, idx):
    """table (..., A, K), idx (..., k) -> (..., k, K)."""
    return torch.gather(table, -2,
                        idx[..., None].expand(*idx.shape, table.shape[-1]))


def decode_at(cls_score, bbox_pred, dir_pred, anchors, idx,
              cfg: DecodeCfg = DecodeCfg()):
    """Decode the anchors at flat indices ``idx`` (..., k): (..., k, 9)
    boxes with the direction bin folded into yaw, (..., k, C) sigmoid
    scores."""
    code_size, aa = anchors.shape[-1], anchors.shape[-2]
    lead = cls_score.shape[:-3]
    a = anchors.numel() // code_size
    num_classes = cls_score.shape[-1] // aa
    bb = _rows(bbox_pred.reshape(*lead, a, code_size), idx)
    dp = _rows(dir_pred.reshape(*lead, a, 2), idx)
    lg = _rows(cls_score.reshape(*lead, a, num_classes), idx)
    an = anchors.reshape(a, code_size)[idx]
    boxes = decode_boxes(an, bb)
    dir_bin = dp.argmax(-1).to(boxes.dtype)
    dir_rot = limit_period(boxes[..., 6] - cfg.dir_offset,
                           cfg.dir_limit_offset, math.pi)
    yaw = dir_rot + cfg.dir_offset + math.pi * dir_bin
    boxes = torch.cat([boxes[..., :6], yaw[..., None], boxes[..., 7:]], -1)
    return boxes, torch.sigmoid(lg)


def anchor_head_decode_candidates(cls_score, bbox_pred, dir_pred, anchors,
                                  cfg: DecodeCfg = DecodeCfg()):
    """The top ``nms_pre`` anchors by max class score, decoded.

    The key is ``sigmoid(max logit)``, as in JAX (bit-identical keys to
    the max of the sigmoids, so only tie order can differ).
    """
    aa = anchors.shape[-2]
    lead = cls_score.shape[:-3]
    a = anchors.numel() // anchors.shape[-1]
    logits = cls_score.reshape(*lead, a, cls_score.shape[-1] // aa)
    key = torch.sigmoid(logits.amax(-1))
    idx = torch.topk(key, min(cfg.nms_pre, a), dim=-1).indices
    return decode_at(cls_score, bbox_pred, dir_pred, anchors, idx, cfg)


def anchor_head_get_bboxes(cls_score, bbox_pred, dir_pred, anchors,
                           cfg: DecodeCfg = DecodeCfg()):
    """Head outputs -> padded (..., max_num, 9) boxes, scores, labels and
    validity (decode + rotated NMS)."""
    boxes, scores = anchor_head_decode_candidates(
        cls_score, bbox_pred, dir_pred, anchors, cfg)
    return multiclass_nms_rotated(boxes, scores, cfg.score_thr, cfg.nms_thr,
                                  cfg.max_num)



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
# ---- training: the sorted pillar path (pillar_encoders.py, voxelize.py) ----

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


# ---- training: targets and losses (target_assign.py, losses.py) ----

def nearest_bev(boxes):
    """Rotated BEV boxes -> nearest axis-aligned (..., 4) (x1, y1, x2, y2):
    the xy extents swap when the yaw is closer to +-pi/2."""
    rot = limit_period(boxes[..., 6], 0.5, math.pi)
    swap = rot.abs() > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    cx, cy = boxes[..., 0], boxes[..., 1]
    return torch.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2],
                       dim=-1)


def iou_2d(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise IoU (..., N, M) of axis-aligned (..., N, 4) and (..., M,
    4) (x1, y1, x2, y2) boxes."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))[..., :, None]
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))[..., None, :]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1 + area2 - inter).clamp(min=eps)


def bbox_overlaps_nearest_3d(boxes1, boxes2):
    """Nearest-BEV IoU matrix (..., N, M) of 7+-dim boxes (the assigner's
    metric, mmdet3d ``BboxOverlapsNearest3D``)."""
    return iou_2d(nearest_bev(boxes1), nearest_bev(boxes2))


def encode_boxes(anchors, gt):
    """Anchor-relative regression targets (mmdet3d
    ``DeltaXYZWLHRBBoxCoder``); anchors and gt (..., 9)."""
    xa, ya, za, wa, la, ha, ra, vxa, vya = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg, vxg, vyg = gt.unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la * la + wa * wa)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                        torch.log(wg / wa), torch.log(lg / la),
                        torch.log(hg / ha), rg - ra, (vxg - vxa) / diag,
                        (vyg - vya) / diag], dim=-1)



class AnchorTargets(NamedTuple):
    """Per-anchor training targets, (B, A) or (B, A, 9)."""

    labels: torch.Tensor         # int32 class id; num_classes = background
    label_weights: torch.Tensor  # 1 for pos + neg, 0 for ignored
    bbox_targets: torch.Tensor   # encoded deltas (B, A, 9)
    bbox_weights: torch.Tensor   # 1 for pos anchors
    dir_targets: torch.Tensor    # int32 direction bin (0 / 1)
    num_pos: torch.Tensor        # (B,) int32


@torch.no_grad()
def assign_targets(anchors, gt_boxes, gt_labels, gt_mask, num_classes: int,
                   pos_iou_thr: float = 0.6, neg_iou_thr: float = 0.3,
                   min_pos_iou: float = 0.3,
                   dir_offset: float = 0.7854) -> AnchorTargets:
    """anchors (A, 9); gt_boxes (B, G, 9), gt_labels (B, G) int, gt_mask
    (B, G) bool."""
    g = gt_boxes.shape[1]
    iou = bbox_overlaps_nearest_3d(gt_boxes, anchors)          # (B, G, A)
    iou = torch.where(gt_mask[..., None], iou, -1.0)

    anchor_max = iou.amax(1)                                   # (B, A)
    anchor_arg = iou.argmax(1)
    pos, neg = anchor_max >= pos_iou_thr, anchor_max < neg_iou_thr

    # GT-forcing: each valid GT claims the anchors at its max IoU (if >=
    # min_pos_iou); the last claiming GT wins, like the reference's loop.
    gt_max = iou.amax(2, keepdim=True)                         # (B, G, 1)
    claims = (iou == gt_max) & (gt_max >= min_pos_iou) & gt_mask[..., None]
    claimed = claims.any(1)
    gt_index = torch.arange(g, device=iou.device)[:, None]
    claim_gt = torch.where(claims, gt_index, -1).argmax(1)

    assigned = torch.where(claimed, claim_gt,
                           torch.where(pos, anchor_arg, 0))
    is_pos = claimed | pos
    is_neg = neg & ~claimed
    label_weights = (is_pos | is_neg).float()
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, assigned),
                         num_classes).to(torch.int32)

    matched = torch.gather(gt_boxes, 1, assigned[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))                           # (B, A, 9)
    bbox_targets = torch.where(is_pos[..., None],
                               encode_boxes(anchors, matched), 0.0)
    # Direction bin: floor((gt_yaw - dir_offset) / pi) mod 2.
    rot = matched[..., 6] - dir_offset
    dir_targets = torch.floor(rot * (1.0 / math.pi)).to(torch.int32) % 2
    dir_targets = torch.where(is_pos, dir_targets, 0).to(torch.int32)
    return AnchorTargets(labels, label_weights, bbox_targets, is_pos.float(),
                         dir_targets, is_pos.sum(1, dtype=torch.int32))



def sigmoid_focal_loss(logits, one_hot_targets, gamma: float = 2.0,
                       alpha: float = 0.25):
    """Element-wise sigmoid focal loss (the shape of ``logits``)."""
    p = torch.sigmoid(logits)
    t = one_hot_targets
    ce = torch.logaddexp(torch.zeros_like(logits), logits) - logits * t
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return alpha_t * (1 - p_t) ** gamma * ce


def smooth_l1(pred, target, beta: float = 1.0 / 9.0):
    """Element-wise smooth L1 (Huber) loss; ``/ beta`` as jitted JAX
    computes it (a multiply by ``1 / beta``)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff * (1.0 / beta),
                       diff - 0.5 * beta)


def softmax_cross_entropy(logits, labels):
    """Per-element CE of logits (..., K) at integer labels (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]



class HeadLossConfig(NamedTuple):
    num_classes: int = 4
    code_weights: Sequence[float] = (1.0,) * 7 + (0.2, 0.2)
    dir_offset: float = 0.7854
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    cls_weight: float = 1.0
    bbox_weight: float = 1.0
    dir_weight: float = 0.2


def _add_sin_difference(pred_rot, target_rot):
    """(sin(a) cos(b), cos(a) sin(b)): L1 on their difference is L1 on
    sin(a - b) (mmdet3d ``add_sin_difference``)."""
    return (torch.sin(pred_rot) * torch.cos(target_rot),
            torch.cos(pred_rot) * torch.sin(target_rot))


def anchor_head_loss(cls_score, bbox_pred, dir_pred, anchors, gt_boxes,
                     gt_labels, gt_mask,
                     cfg: HeadLossConfig = HeadLossConfig()
                     ) -> dict:
    """Batch-mean anchor head losses.

    cls_score (B, H, W, A*C), bbox_pred (B, H, W, A*9), dir_pred (B, H, W,
    A*2), anchors (H, W, A, 9) shared by the batch, gt_boxes (B, G, 9),
    gt_labels (B, G), gt_mask (B, G).  Returns 'loss_cls', 'loss_bbox',
    'loss_dir' and 'num_pos' (the batch mean of each sample's count).
    The terms are evaluated in the predictions' dtype, promoted with the
    f32 targets as ``jnp`` promotes them (the JAX loss under its bf16
    policy); ``train/builder.py:DetectionLosses`` picks that dtype.
    """
    b, nc = cls_score.shape[0], cfg.num_classes
    flat_anchors = anchors.reshape(-1, anchors.shape[-1]).float()
    a, code = flat_anchors.shape
    cls_score = cls_score.reshape(b, a, nc)
    bbox_pred = bbox_pred.reshape(b, a, code)
    dir_pred = dir_pred.reshape(b, a, 2)

    tgt = assign_targets(flat_anchors, gt_boxes.float(), gt_labels, gt_mask,
                         nc, cfg.pos_iou_thr, cfg.neg_iou_thr,
                         cfg.min_pos_iou, cfg.dir_offset)
    num_pos = tgt.num_pos.float().clamp(min=1.0)                # (B,)

    # Classification: one-hot with an all-zero background row (a compare:
    # F.one_hot checks its range on the host, which waits for the card).
    one_hot = (tgt.labels[..., None] == torch.arange(
        nc, device=tgt.labels.device)).float()
    cls_loss = sigmoid_focal_loss(cls_score, one_hot)
    cls_loss = (cls_loss * tgt.label_weights[..., None]).sum((1, 2)) / num_pos

    # Regression with the sin-difference yaw.
    pred_rot, tgt_rot = _add_sin_difference(bbox_pred[..., 6],
                                            tgt.bbox_targets[..., 6])
    pred = torch.cat([bbox_pred[..., :6], pred_rot[..., None],
                      bbox_pred[..., 7:]], -1)
    target = torch.cat([tgt.bbox_targets[..., :6], tgt_rot[..., None],
                        tgt.bbox_targets[..., 7:]], -1)
    code_w = torch.tensor(cfg.code_weights, dtype=torch.float32,
                          device=pred.device)
    reg_loss = smooth_l1(pred, target) * code_w
    reg_loss = (reg_loss * tgt.bbox_weights[..., None]).sum((1, 2)) / num_pos

    # Direction classification on the positive anchors.
    dir_loss = softmax_cross_entropy(dir_pred, tgt.dir_targets)
    dir_loss = (dir_loss * tgt.bbox_weights).sum(1) / num_pos

    return {'loss_cls': (cfg.cls_weight * cls_loss).mean(),
            'loss_bbox': (cfg.bbox_weight * reg_loss).mean(),
            'loss_dir': (cfg.dir_weight * dir_loss).mean(),
            'num_pos': tgt.num_pos.float().mean()}



def depth_dist_loss(pred_depth, gt_gaussian, gt_min_depth,
                    camera_depth_range, method: str = 'kld'):
    """KL depth-distribution loss over the pixels whose min depth lies in
    the camera's range (one process: no data-parallel group)."""
    pred, gt = pred_depth, gt_gaussian
    mask = ((gt_min_depth >= camera_depth_range[0])
            & (gt_min_depth <= camera_depth_range[1]))
    denom = mask.sum().clamp(min=1)
    per = (gt * (torch.log(gt.clamp(min=1e-12))
                 - torch.log(pred + 1e-4))).sum(-1)
    return torch.where(mask, per, 0.0).sum() / denom


def detection_loss(out, batch, anchors, depth_loss_weight: float,
                   camera_depth_range):
    """(total, terms): the anchor head's focal + smooth-L1 + direction
    losses plus the weighted depth loss, in f32
    (``train/builder.py:DetectionLosses``)."""
    terms = anchor_head_loss(out['cls_score'].float(),
                             out['bbox_pred'].float(),
                             out['dir_pred'].float(), anchors,
                             batch['gt_boxes'].float(), batch['gt_labels'],
                             batch['gt_mask'], HeadLossConfig())
    total = terms['loss_cls'] + terms['loss_bbox'] + terms['loss_dir']
    terms['loss_depth'] = depth_dist_loss(
        out['depth'].float(), batch['depth_gaussian'].float(),
        batch['depth_min'], camera_depth_range)
    return total + depth_loss_weight * terms['loss_depth'], terms
