"""The least time one H100 SXM could take for a kernel's work: the bound
that ``chip_smoke.py`` and ``tools/profile_components.py`` set beside
each measured time.

A bound is the larger of the operations over the card's dense peak for
their type and the bytes the function must move (each input element it
needs read once, each output written once) over the HBM rate.
"""

from __future__ import annotations

# Dense tensor-core peaks, the f32 rate outside the tensor cores and the
# HBM3 rate of one H100 SXM (NVIDIA's data sheet).
PEAK_OPS = {'int8': 1979e12, 'bf16': 989e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: float, kind: str, nbytes: float) -> tuple:
    """(least ms, 'operations' or 'bytes'): the larger of ``ops`` over the
    dense peak of ``kind`` and ``nbytes`` over the HBM rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3 if ops else 0.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def conv_cost(n: int, c: int, h: int, w: int, co: int, in_bytes: int,
              out_bytes: int) -> tuple:
    """(operations, bytes) of one fused 3x3 conv of an (N, C, H, W) input
    to Co channels: 2 * 9 * C * Co per output pixel; x, the weight and
    the f32 scale and shift read once, the output written once."""
    ops = 2 * 9 * c * co * n * h * w
    nbytes = (n * h * w * c + 9 * c * co) * in_bytes + 2 * co * 4 \
        + n * h * w * co * out_bytes
    return ops, nbytes


def splat_cost(depth_elems: int, feat_elems: int, in_range: int,
               channels: int, out_elems: int, in_bytes: int,
               out_bytes: int) -> tuple:
    """(operations, bytes) of the scatter splat (``ops/bev_pool.py``): a
    multiply and an add per channel for each frustum point that lands in
    the grid (this run's count, in f32); the depth and the features read
    once, the grid written once (the ids come from the camera geometry)."""
    return (2 * in_range * channels,
            (depth_elems + feat_elems) * in_bytes + out_elems * out_bytes)
