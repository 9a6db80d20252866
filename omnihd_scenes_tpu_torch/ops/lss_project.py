"""Sampling-dual LSS view transform (counterpart of
``omnihd_scenes_tpu/ops/lss_project.py``).

For every BEV voxel centre and camera, back-project into the image and
read the depth-weighted feature there (Simple-BEV-style sampling; see the
JAX module's docstring for the geometry).  The index fields are plain
tensor code, op for op the JAX ``_sample_indices``; the gather-multiply-
sum runs in :func:`omnihd_scenes_tpu_torch.kernels.lss_sample.lss_sample`
(the CUDA kernel on the card, its plain version on the CPU).  The JAX
module's one-hot einsum forms and FOV ``b_windows`` are TPU workarounds
for a gather and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample

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
    qf = a_col[..., None, None, None] * gc + cc[..., None]  # (..., 3, nz, n_b, n_g)
    d_star = qf[..., 2, :, :, :]
    vs = _safe_div(qf[..., 1, :, :, :], d_star)
    ok2 = (d_star > d_floor) & (vs > -0.5) & (vs < g.h_img - 0.5)
    j_star = _clean_idx(vs * g.v_scale, ok2)
    kd_star = _clean_idx((d_star - g.d0) / g.dd, ok2)
    return i_star, j_star, kd_star


class SampleFields(NamedTuple):
    """Index fields of a batch in the kernel's layout (see
    :mod:`omnihd_scenes_tpu_torch.kernels.lss_sample`)."""
    i_star: torch.Tensor    # (B, N, fH, nz, max(nx, ny)) int32
    j_star: torch.Tensor    # (B, N, nz, ny * nx) int32
    kd_star: torch.Tensor   # (B, N, nz, ny * nx) int32


def camera_geometry(rots, trans):
    """img->lidar (rots, trans) -> lidar->image (minv, mt), f32."""
    minv = torch.linalg.inv(rots.float())
    mt = -torch.einsum('...ij,...j->...i', minv, trans.float())
    return minv, mt


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


def sample_fields(rots, trans, g: _Geom, solve_x: Sequence[bool]) -> SampleFields:
    """Index fields of a batch: rots (B, N, 3, 3), trans (B, N, 3)."""
    minv, mt = camera_geometry(rots, trans)
    per_camera = [None] * len(solve_x)
    for sx in (True, False):
        cams = [n for n, s in enumerate(solve_x) if bool(s) == sx]
        if not cams:
            continue
        i, j, kd = _sample_indices(minv[:, cams], mt[:, cams], sx, g)
        for k, n in enumerate(cams):
            per_camera[n] = (i[:, k], j[:, k], kd[:, k])
    return pack_fields(per_camera, g)


def lss_sample_bev(depth: torch.Tensor,
                   feat: torch.Tensor,
                   rots: torch.Tensor,
                   trans: torch.Tensor,
                   *,
                   image_size: Tuple[int, int],
                   depth_range: Tuple[float, float, float],
                   bev_start: Sequence[float],
                   bev_voxel: Sequence[float],
                   bev_nx: Sequence[int],
                   solve_x: Sequence[bool]) -> torch.Tensor:
    """Sample camera features into the BEV grid, for a batch.

    Args as the JAX ``lss_sample_bev`` with a batch dim in front:
    depth (B, N, fH, fW, D), feat (B, N, fH, fW, C), rots (B, N, 3, 3),
    trans (B, N, 3).  Returns (B, nz, ny, nx, C) in ``feat``'s dtype — per
    sample the JAX layout — as a view of the kernel's (B, ny, nx, nz, C)
    result.
    """
    n_cams, f_h, f_w = depth.shape[1:4]
    if len(solve_x) != n_cams:
        raise ValueError(f'{len(solve_x)} solve_x flags for {n_cams} cameras')
    g = _Geom(image_size, (f_h, f_w), depth_range, bev_start, bev_voxel,
              bev_nx)
    fields = sample_fields(rots, trans, g, solve_x)
    out = lss_sample(feat.contiguous(), depth.contiguous(), *fields,
                     solve_x=solve_x, ny=g.ny, nx=g.nx)
    return out.permute(0, 3, 1, 2, 4)
