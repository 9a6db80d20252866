"""Aligned 3D anchor grid (counterpart of
``omnihd_scenes_tpu/models/anchors.py``), built once on the host.

mmdet3d's ``AlignedAnchor3DRangeGenerator`` as the 4D-radar PointPillars
config sets it up: one (z, size) pair per class over a shared xy range,
the given rotations, two velocity values per anchor.  Layout
(H, W, num_sizes * num_rots, 9), sizes major, which is the order the
head's conv outputs are reshaped in.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def aligned_anchor_grid(feature_hw: Sequence[int],
                        ranges: List[Sequence[float]],
                        sizes: List[Sequence[float]],
                        rotations: Sequence[float] = (0.0, 1.5707963),
                        custom_values: Sequence[float] = (0.0, 0.0)
                        ) -> np.ndarray:
    """(H, W, num_sizes * num_rots, 7 + len(custom_values)) float32
    anchors; H indexes y, W x, centres at half-stride offsets."""
    h, w = feature_hw
    num_rot = len(rotations)
    per_size = []
    for rng, size in zip(ranges, sizes):
        x0, y0, z, x1, y1, _ = rng
        xs = x0 + (np.arange(w) + 0.5) * ((x1 - x0) / w)
        ys = y0 + (np.arange(h) + 0.5) * ((y1 - y0) / h)
        gx, gy = np.meshgrid(xs, ys)                    # (H, W)
        base = np.zeros((h, w, num_rot, 7 + len(custom_values)),
                        dtype=np.float32)
        base[..., 0] = gx[..., None]
        base[..., 1] = gy[..., None]
        base[..., 2] = z
        base[..., 3:6] = size
        base[..., 6] = np.asarray(rotations)
        base[..., 7:] = custom_values
        per_size.append(base)
    return np.stack(per_size, axis=2).reshape(
        h, w, len(sizes) * num_rot, 7 + len(custom_values))
