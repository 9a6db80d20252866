"""Chamfer distance (occupancy reconstruction eval helper; counterpart of
``omnihd_scenes_tpu/ops/chamfer.py``, which stands in for the chamfer
CUDA extension of the reference's ``datasets/evaluation_metrics.py:3,32``).

Plain PyTorch: the JAX function is a pairwise minimum outside any Pallas
kernel.  JAX writes ``sum((x[:, None] - y[None]) ** 2, -1)`` per chunk of
``x`` and XLA fuses it; eager PyTorch would materialise chunk x M x 3
values (4.9 GB at chunk 4096 and M = 100k).  Here both clouds are cut
into tiles of ``chunk`` points, and a tile's squared distances are summed
coordinate by coordinate (the order of JAX's sum over the last axis) into
one chunk x chunk buffer.  Each tile is formed once: its row minima
update ``a``'s running minimum and its column minima ``b``'s.  The peak
beyond the inputs and the two (N,) / (M,) results is about three chunk x
chunk buffers of the clouds' dtype: 201 MB at chunk 4096 in f32.  Minima
are exact, so the result does not depend on ``chunk``;
``torch.cdist``'s default expansion ``|x|^2 + |y|^2 - 2 x.y`` would lose
the small distances to cancellation.
"""

from __future__ import annotations

import torch


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096):
    """Symmetric chamfer distance between (N, 3) and (M, 3) clouds.

    Returns (mean_a_to_b, mean_b_to_a) of squared distances, 0-dim
    tensors on the clouds' device.
    """
    near_a = torch.full(a.shape[:1], float('inf'), dtype=a.dtype,
                        device=a.device)
    near_b = torch.full(b.shape[:1], float('inf'), dtype=b.dtype,
                        device=b.device)
    for i in range(0, a.shape[0], chunk):
        ac = a[i:i + chunk]
        for j in range(0, b.shape[0], chunk):
            bc = b[j:j + chunk]
            d = (ac[:, None, 0] - bc[:, 0]) ** 2
            for k in range(1, a.shape[1]):
                d += (ac[:, None, k] - bc[:, k]) ** 2
            near_a[i:i + chunk] = torch.minimum(near_a[i:i + chunk],
                                                d.amin(1))
            near_b[j:j + chunk] = torch.minimum(near_b[j:j + chunk],
                                                d.amin(0))
    return near_a.mean(), near_b.mean()
