"""Sampling-dual LSS view transform (counterpart of
``omnihd_scenes_tpu/ops/lss_project.py``).

For every BEV voxel centre and camera, back-project into the image and
read the depth-weighted feature there (Simple-BEV-style sampling; see the
JAX module's docstring for the geometry).  The camera geometry (minv, mt)
is inverted here in plain PyTorch, as the JAX module inverts it outside
its kernel; the index fields and the gather-multiply-sum run in
:class:`omnihd_scenes_tpu_torch.kernels.lss_sample.LSSSampleBEV` (one
fused CUDA kernel on the card, its plain version, op for op the JAX
``_sample_indices`` and a gather, on the CPU; its backward a CUDA
scatter kernel on the card and ``index_add_`` on the CPU).  The JAX module's one-hot
einsum forms and FOV ``b_windows`` are TPU workarounds for a gather and
are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from omnihd_scenes_tpu_torch.kernels import lss_sample as lss_kernel
from omnihd_scenes_tpu_torch.kernels.lss_sample import (  # noqa: F401
    SampleFields, _Geom, _sample_indices, geometry_fields, pack_fields)


def check_rotations(rots) -> None:
    """Raise if a camera rotation (..., 3, 3) held on the host (a NumPy
    array or a CPU tensor) is non-finite or singular: that camera would
    otherwise see no BEV cell, without a word.  A tensor on the card is
    not checked here, as reading the check would wait for the device;
    ``Predictor`` checks a request's rotations before it uploads them."""
    if isinstance(rots, torch.Tensor) and rots.device.type != 'cpu':
        return
    r = torch.as_tensor(rots).float()
    if not bool(torch.isfinite(r).all()) \
            or bool(torch.linalg.inv_ex(r)[1].any()):
        raise ValueError('camera rotations must be finite and invertible')


def camera_geometry(rots, trans):
    """img->lidar (rots, trans) -> lidar->image (minv, mt), f32.

    ``inv_ex`` is ``inv`` without the check of its error flags, which on
    the card waits for the device; rotations on the host are checked
    first (:func:`check_rotations`)."""
    check_rotations(rots)
    minv = torch.linalg.inv_ex(rots.float())[0]
    mt = -torch.einsum('...ij,...j->...i', minv, trans.float())
    return minv, mt


def sample_fields(rots, trans, g: _Geom, solve_x: Sequence[bool]) -> SampleFields:
    """Index fields of a batch: rots (B, N, 3, 3), trans (B, N, 3)."""
    return geometry_fields(*camera_geometry(rots, trans), g, solve_x)


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
    minv, mt = camera_geometry(rots, trans)
    out = lss_kernel.LSSSampleBEV.apply(
        feat.contiguous(), depth.contiguous(), minv.contiguous(),
        mt.contiguous(), g, solve_x)
    return out.permute(0, 3, 1, 2, 4)
