"""Bilinear sampling of a feature map at continuous pixel coordinates
(counterpart of ``bilinear_sample`` in
``omnihd_scenes_tpu/ops/ms_deform_attn.py``, restated for the BEV grid
crop of ``models/mtl.py``).

The semantics are ``F.grid_sample(align_corners=False,
padding_mode='zeros')`` after its ``loc * size - 0.5`` shift: (0, 0) is
the centre of the top-left texel and taps outside the map read 0.  The
weights are the JAX package's tent formula ``relu(1 - |x - X|) * relu(1 -
|y - Y|)`` at the absolute coordinates of a 2x2 patch whose anchor is
clipped into the map, so every in-map tap of a location's support is
covered and a location wholly outside gets weight 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(value, loc_x, loc_y):
    """Sample ``value`` (B, C, H, W) at the locations ``loc_x`` / ``loc_y``
    (same shape, any, in pixel units) -> (B, C, *loc.shape), in the
    promoted dtype of ``value`` and the locations."""
    h, w = value.shape[-2:]
    if h < 2 or w < 2:
        # Zero rows / columns keep the zero out-of-range semantics.
        value = F.pad(value, (0, max(0, 2 - w), 0, max(0, 2 - h)))
        h, w = max(h, 2), max(w, 2)
    ys = torch.floor(loc_y).clamp(0, h - 2).long()
    xs = torch.floor(loc_x).clamp(0, w - 2).long()
    offs = torch.arange(2, device=value.device)
    wx = (1.0 - (loc_x[..., None] - (xs[..., None] + offs)).abs()).clamp(
        min=0.0)
    wy = (1.0 - (loc_y[..., None] - (ys[..., None] + offs)).abs()).clamp(
        min=0.0)
    flat = value.flatten(2)                                  # (B, C, H*W)
    out = 0.0
    for a in range(2):
        for b in range(2):
            idx = ((ys + a) * w + (xs + b)).reshape(-1)
            tap = flat[:, :, idx].reshape(*value.shape[:2], *loc_x.shape)
            out = out + tap * (wy[..., a] * wx[..., b])
    return out
