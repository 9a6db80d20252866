"""The roofline's yardsticks, frozen: the data sheet's peaks, the bound
of an operation count and a byte count, and the byte and operation counts
of the LSS view-transform kernels.

Copies of ``omnihd_scenes_tpu_torch/tools/roofline.py:bound`` and of
``kernels/lss_sample.py:lss_sample_bev_bytes`` / ``lss_sample_bytes`` /
``lss_sample_bev_backward_cost`` as they stood when the benchmark was
defined, over the benchmark's own copy of the index fields
(``perfbench/reference/bevfusion.py``), so that a change to the program
cannot move its own denominator.
"""

from __future__ import annotations

from typing import Sequence

import torch

from perfbench.reference.bevfusion import (_camera_cells, _Geom,
                                           cell_indices, geometry_fields)

# Dense peaks of one H100 SXM and its HBM3 rate (NVIDIA's data sheet).
PEAK_OPS = {'int8': 1979e12, 'bf16': 989e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: float, kind: str, nbytes: float) -> tuple:
    """(least ms, 'operations' or 'bytes'): the larger of ``ops`` over
    the dense peak of ``kind`` and ``nbytes`` over the HBM rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3 if ops else 0.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def _distinct(index, mask) -> int:
    return int(torch.unique(index.long()[mask]).numel())


def lss_sample_bytes(feat, depth, i_star, j_star, kd_star,
                     solve_x: Sequence[bool], ny: int, nx: int,
                     out_dtype: torch.dtype, fields_read: bool = True) -> int:
    """Bytes the sampling must move, each needed element once: every
    gathered depth value and feature row of a contributing (cell,
    camera), the output written once, and with ``fields_read`` the index
    fields read."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    words_per_image = f_h * i_star.shape[3] * i_star.shape[4]
    nbytes = b * ny * nx * j_star.shape[2] * c_ch * out_dtype.itemsize
    if fields_read:
        nbytes += 4 * (j_star.numel() + kd_star.numel())
    for _, j, i, kd, word, read_i in _camera_cells(
            i_star, j_star, kd_star, solve_x, ny, nx, d_bins):
        ok = read_i & (i >= 0) & (i < f_w)
        pix = (bb * f_h + j.long()) * f_w + i
        if fields_read:
            nbytes += 4 * _distinct(bb * words_per_image + word, read_i)
        nbytes += feat.element_size() * c_ch * _distinct(pix, ok)
        nbytes += depth.element_size() * _distinct(pix * d_bins + kd, ok)
    return nbytes


def lss_sample_bev_bytes(feat, depth, minv, mt, geom: _Geom,
                         solve_x: Sequence[bool],
                         out_dtype: torch.dtype) -> int:
    """Bytes of the fused geometry-in sampling: :func:`lss_sample_bytes`
    without index fields, plus ``minv``, ``mt`` and the coordinate
    tables."""
    fields = geometry_fields(minv, mt, geom, solve_x)
    tables = geom.f_h + geom.nx + geom.ny + geom.nz
    return (lss_sample_bytes(feat, depth, *fields, solve_x, geom.ny, geom.nx,
                             out_dtype, fields_read=False)
            + 4 * (minv.numel() + mt.numel() + tables))


def lss_sample_bev_backward_cost(grad, feat, depth, minv, mt, geom: _Geom,
                                 solve_x: Sequence[bool]):
    """(f32 operations, bytes) of the sampling's backward: 4 C operations
    per in-range (cell, camera); the forward's bytes with the gradient in
    place of the output, plus d feat and d depth written once."""
    idx = cell_indices(*geometry_fields(minv, mt, geom, solve_x), solve_x,
                       geom.ny, geom.nx, depth.shape[-1])
    f_h, f_w, d_bins = feat.shape[2], feat.shape[3], depth.shape[-1]
    j, i, kd = idx
    pairs = int(((j >= 0) & (j < f_h) & (i >= 0) & (i < f_w) & (kd >= 0)
                 & (kd < d_bins)).sum())
    nbytes = (lss_sample_bev_bytes(feat, depth, minv, mt, geom, solve_x,
                                   grad.dtype)
              + feat.numel() * feat.element_size()
              + depth.numel() * depth.element_size())
    return 4 * feat.shape[-1] * pairs, nbytes
