"""Multi-scale deformable attention, plain PyTorch (counterpart of
``omnihd_scenes_tpu/ops/ms_deform_attn.py``).

The semantics are the reference's ``multi_scale_deformable_attn_pytorch``
(mmcv's CUDA kernel's specification): per level, the value map is sampled
bilinearly at the predicted locations with ``F.grid_sample(
align_corners=False, padding_mode='zeros')`` semantics -- a normalised
location in [0, 1] maps to the pixel centre ``loc * size - 0.5`` and taps
outside the map read 0 -- weighted by the attention weights and summed
over levels and points.  The JAX package's patch-gather form
(``impl='gather'``) is what the port is held to; its one-hot and windowed
duals are TPU formulations and are not carried over.

:func:`multi_scale_deformable_attn` samples with ``F.grid_sample``, one
call per level and query chunk, in f32 whatever the value's dtype (f64
when the value or the locations are f64), so the
sampling positions keep f32 precision in the bf16 path (a bf16 location
in [0, 1] is off by up to about one cell of a 240-cell map).  It is not a
hand kernel: the BEVFormer path runs it as plain PyTorch until a profile
on the card points at it.  ``multi_scale_deformable_attn.calls`` counts
its calls (the smoke reads it per frame).

Every function takes a leading batch dimension where JAX samples one
sample (and vmaps).  :func:`bilinear_sample` also serves BEVFormer's BEV
rotation and BEVFusion-OCC's grid crop (``models/mtl.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# The f32 tensor of sampled taps (batch, heads, head_dim, queries, points)
# of one query chunk is kept under this many elements (256 MB), the
# bound of the JAX package's chunking (``ops/ms_deform_attn.py:361``).
CHUNK_ELEMENTS = 64_000_000


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in its own dtype where that is wider (f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bilinear_sample(value: torch.Tensor, loc_xy: torch.Tensor) -> torch.Tensor:
    """Sample ``value`` (B, H, W, C) at ``loc_xy`` (B, ..., 2), continuous
    pixel coordinates where (0, 0) is the centre of the top-left texel ->
    (B, ..., C) in the promoted dtype of value and locations.

    The JAX package's form: one 2x2 patch per location whose anchor is
    clipped into the map, so each in-map tap of the support is covered and
    out-of-map taps weigh 0.  A map of height or width 1 is padded with
    zeros to 2 first.  A patch column X weighs ``1 - f`` where X is
    ``floor(x)``, ``f`` where X is ``floor(x) + 1`` and 0 elsewhere, with
    ``f = x - floor(x)`` (rows alike): JAX's tent ``relu(1 - |x - X|)`` in
    value, but with the floor-side derivative at a tap exactly on a texel
    centre, the side ``F.grid_sample`` and mmcv's kernels take (JAX's tent
    takes neither side there; ROADMAP queue 3 item 17).
    """
    b, h, w, c = value.shape
    if h < 2 or w < 2:
        value = F.pad(value, (0, 0, 0, max(0, 2 - w), 0, max(0, 2 - h)))
        h, w = max(h, 2), max(w, 2)
    x, y = loc_xy[..., 0], loc_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ys = y0.clamp(0, h - 2).long()
    xs = x0.clamp(0, w - 2).long()
    offs = torch.arange(2, device=value.device)

    def weights(t, t0, start):
        frac = (t - t0)[..., None]
        col = start[..., None] + offs - t0.long()[..., None]   # X - floor(t)
        return torch.where(col == 0, 1.0 - frac,
                           torch.where(col == 1, frac, 0.0))

    wx, wy = weights(x, x0, xs), weights(y, y0, ys)
    flat = value.reshape(b, h * w, c)
    out = 0.0
    for a in range(2):
        for d in range(2):
            idx = ((ys + a) * w + (xs + d)).reshape(b, -1, 1)
            tap = torch.gather(flat, 1, idx.expand(-1, -1, c))
            out = out + tap.reshape(*x.shape, c) * (
                wy[..., a] * wx[..., d])[..., None]
    return out


def _level_values(value, spatial_shapes, dtype=None):
    """(B, S, heads, hd) -> per level (B * heads, hd, H, W) in ``dtype``
    (default: at least f32)."""
    b, _, nh, hd = value.shape
    dtype = dtype or torch.promote_types(value.dtype, torch.float32)
    out, start = [], 0
    for h, w in spatial_shapes:
        v = value[:, start:start + h * w].to(dtype)
        start += h * w
        out.append(v.permute(0, 2, 3, 1).reshape(b * nh, hd, h, w))
    return out


def _sample_chunk(levels, loc, weights):
    """One query chunk: loc (B, q, heads, L, P, 2), weights (B, q, heads,
    L, P) -> (B * heads, hd, q) in the levels' dtype."""
    b, q, nh, _, p, _ = loc.shape
    dtype = levels[0].dtype
    acc = 0.0
    for lvl, v in enumerate(levels):
        grid = loc[:, :, :, lvl].to(dtype).permute(0, 2, 1, 3, 4).reshape(
            b * nh, q, p, 2) * 2.0 - 1.0
        taps = F.grid_sample(v, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=False)       # (B*nh, hd, q, P)
        wgt = weights[:, :, :, lvl].to(dtype).permute(0, 2, 1, 3).reshape(
            b * nh, 1, q, p)
        acc = acc + (taps * wgt).sum(-1)
    return acc


def multi_scale_deformable_attn(value: torch.Tensor,
                                spatial_shapes: Sequence[Tuple[int, int]],
                                sampling_locations: torch.Tensor,
                                attention_weights: torch.Tensor,
                                query_chunk: Optional[int] = None
                                ) -> torch.Tensor:
    """Deformable attention.

    Args:
        value: (B, sum_l H_l * W_l, num_heads, head_dim).
        spatial_shapes: static list of (H_l, W_l).
        sampling_locations: (B, num_query, num_heads, num_levels,
            num_points, 2) normalised to [0, 1], (x, y).
        attention_weights: (B, num_query, num_heads, num_levels,
            num_points).
        query_chunk: queries per ``grid_sample`` call; None bounds the f32
            tap tensor of a chunk to ``CHUNK_ELEMENTS``.

    Returns:
        (B, num_query, num_heads * head_dim) in value's dtype.
    """
    multi_scale_deformable_attn.calls += 1
    b, nq, nh, _, p, _ = sampling_locations.shape
    hd = value.shape[-1]
    if query_chunk is None:
        query_chunk = max(256, CHUNK_ELEMENTS // max(b * nh * p * hd, 1))
    levels = _level_values(value, spatial_shapes, torch.promote_types(
        torch.promote_types(value.dtype, sampling_locations.dtype),
        torch.float32))
    out = torch.cat([
        _sample_chunk(levels, sampling_locations[:, s:s + query_chunk],
                      attention_weights[:, s:s + query_chunk])
        for s in range(0, nq, query_chunk)], -1)         # (B*nh, hd, nq)
    return out.reshape(b, nh * hd, nq).transpose(1, 2).to(value.dtype)


multi_scale_deformable_attn.calls = 0
