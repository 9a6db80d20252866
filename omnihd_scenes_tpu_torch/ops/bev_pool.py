"""BEV pooling, the LSS splat-sum (counterpart of
``omnihd_scenes_tpu/ops/bev_pool.py``).

Every frustum point adds its depth-weighted camera feature to the BEV
cell it falls in: the reference's ``bev_pool_v2`` CUDA op
(``ops/bev_pool_v2/src/bev_pool_cuda.cu:21-48``), which the JAX package
computes as one XLA scatter-add outside any Pallas kernel.  Here it is
``index_add_`` into an accumulator of at least f32 (the feature's dtype
for f64), cast once to the feature's dtype; JAX accumulates in the
feature's dtype, so the two agree exactly in f32 and differ in bf16 by
the accumulator's rounding.  Out-of-range ids go to rows past the grid
that are sliced off, the form of JAX's ``mode='drop'``.  The gradient is
an ``index_select`` of the output gradient.  On the card the adds are
atomics, so two runs may differ in the last bits.
"""

from __future__ import annotations

from typing import Sequence

import torch


# Out-of-range points are added to one of this many rows past the grid
# (by their index) and sliced off: into a single row their atomic adds on
# the card would all contend for the words of one row.
DROP_ROWS = 1 << 16


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def bev_pool_v2(depth, feat, ranks_depth, ranks_feat, ranks_bev,
                bev_feat_shape: Sequence[int], valid=None):
    """``out[ranks_bev[i]] += depth.flat[ranks_depth[i]] *
    feat.flat_rows[ranks_feat[i]]`` into a (B, Z, Y, X, C) grid.

    depth: any shape (flattened); feat (..., C) (flattened to rows);
    ranks_*: (P,) int32 or int64; ``valid`` (P,) bool drops the points it
    marks False, and so does a ``ranks_bev`` outside [0, B*Z*Y*X).  The
    reference's interval arguments are not needed by a scatter-add and
    are not taken.  Returns (B, Z, Y, X, C) in feat's dtype."""
    b, z, y, x, c = bev_feat_shape
    n_cells = b * z * y * x
    acc_dt = _acc_dtype(feat.dtype)
    weights = depth.reshape(-1)[ranks_depth].to(acc_dt)
    rows = feat.reshape(-1, c)[ranks_feat].to(acc_dt)
    ids = ranks_bev
    keep = (ids >= 0) & (ids < n_cells)
    if valid is not None:
        keep = keep & valid
    spread = n_cells + torch.arange(ids.numel(), device=ids.device,
                                    dtype=ids.dtype) % DROP_ROWS
    out = rows.new_zeros((n_cells + DROP_ROWS, c))
    out.index_add_(0, torch.where(keep, ids, spread),
                   rows * weights[:, None])
    return out[:n_cells].to(feat.dtype).reshape(b, z, y, x, c)


def _chunk_ids(voxel_ids, d0, chunk_d, n_cells, spread):
    ids = voxel_ids[:, d0:d0 + chunk_d].reshape(-1)
    return torch.where((ids >= 0) & (ids < n_cells), ids, spread[:ids.numel()])


class _Splat(torch.autograd.Function):
    """The chunked splat-sum with its own backward: autograd's rule for
    ``index_add_`` would keep every chunk's (P, C) product alive until the
    backward; this one keeps only the inputs and the ids."""

    @staticmethod
    def forward(ctx, depth, feat, voxel_ids, n_cells, chunk_d):
        n, d, h, w = depth.shape
        c = feat.shape[-1]
        acc_dt = _acc_dtype(feat.dtype)
        spread = n_cells + torch.arange(
            n * chunk_d * h * w, device=depth.device,
            dtype=voxel_ids.dtype) % DROP_ROWS
        f = feat.to(acc_dt)[:, None]                    # (N, 1, H, W, C)
        acc = f.new_zeros((n_cells + DROP_ROWS, c))
        for d0 in range(0, d, chunk_d):
            dep = depth[:, d0:d0 + chunk_d].to(acc_dt)[..., None]
            acc.index_add_(0, _chunk_ids(voxel_ids, d0, chunk_d, n_cells,
                                         spread), (f * dep).reshape(-1, c))
        ctx.save_for_backward(depth, feat, voxel_ids)
        ctx.n_cells, ctx.chunk_d = n_cells, chunk_d
        return acc[:n_cells].to(feat.dtype)

    @staticmethod
    def backward(ctx, grad):
        depth, feat, voxel_ids = ctx.saved_tensors
        n_cells, chunk_d = ctx.n_cells, ctx.chunk_d
        n, d, h, w = depth.shape
        c = feat.shape[-1]
        acc_dt = _acc_dtype(feat.dtype)
        spread = n_cells + torch.arange(
            n * chunk_d * h * w, device=depth.device,
            dtype=voxel_ids.dtype) % DROP_ROWS
        g = grad.new_zeros((n_cells + DROP_ROWS, c), dtype=acc_dt)
        g[:n_cells] = grad
        f = feat.to(acc_dt)[:, None]
        d_depth = torch.empty(depth.shape, dtype=acc_dt, device=depth.device)
        d_feat = torch.zeros(f.shape, dtype=acc_dt, device=depth.device)
        for d0 in range(0, d, chunk_d):
            ids = _chunk_ids(voxel_ids, d0, chunk_d, n_cells, spread)
            rows = g.index_select(0, ids).view(n, -1, h, w, c)
            d_depth[:, d0:d0 + chunk_d] = (rows * f).sum(-1)
            d_feat += (rows * depth[:, d0:d0 + chunk_d].to(acc_dt)[
                ..., None]).sum(1, keepdim=True)
        return (d_depth.to(depth.dtype), d_feat[:, 0].to(feat.dtype), None,
                None, None)


def lss_splat(depth, feat, voxel_ids, n_cells: int, chunk_d: int = 4):
    """The model-level splat of one sample, ``chunk_d`` depth bins at a
    time, so neither the whole (P, C) product nor a whole int64 id tensor
    exists at once.

    depth (N, D, H, W) softmax depth; feat (N, H, W, C); voxel_ids (N, D,
    H, W) int32 cell ids, any id outside [0, n_cells) dropped.
    Returns (n_cells, C) in feat's dtype."""
    lss_splat.calls += 1
    return _Splat.apply(depth, feat, voxel_ids, n_cells, chunk_d)


lss_splat.calls = 0


def frustum_voxel_ids(frustum, rots, trans, bev_start: Sequence[float],
                      bev_voxel: Sequence[float], bev_nx: Sequence[int]):
    """The frustum's (u, v, depth) points through each camera's img->lidar
    rotation (N, 3, 3) and translation (N, 3) into flattened BEV ids
    ``((z * ny) + y) * nx + x``, or ``nx * ny * nz`` out of range.

    frustum (D, H, W, 3) in rots' dtype.  Returns (N, D, H, W) int32.
    Each division by a voxel size is a multiply by its reciprocal in the
    points' dtype, as jitted JAX computes it."""
    nx, ny, nz = bev_nx
    uvd = torch.cat([frustum[..., :2] * frustum[..., 2:3],
                     frustum[..., 2:3]], -1)
    pts = torch.einsum('nij,dhwj->ndhwi', rots, uvd)
    pts = pts + trans[:, None, None, None, :]
    cell = [torch.floor((pts[..., k] - bev_start[k]) * (1.0 / bev_voxel[k]))
            for k in range(3)]
    # Validity on the floats, so a NaN point is out of range too.
    ok = torch.ones_like(cell[0], dtype=torch.bool)
    for v, size in zip(cell, (nx, ny, nz)):
        ok &= (v >= 0) & (v < size)
    cx, cy, cz = (torch.where(ok, v, 0).to(torch.int32) for v in cell)
    ids = (cz * ny + cy) * nx + cx
    return torch.where(ok, ids, nx * ny * nz)
