"""The arithmetic of the metrics: percentiles, the device's busy time
from a timeline, and shares of a peak."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, HBM3 3.35 TB/s.
PEAK_FLOPS_BF16 = 989e12


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks (NumPy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('percentile of no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(intervals: Iterable[Tuple[int, int]]
                    ) -> List[Tuple[int, int]]:
    """Union of half-open [start, end) intervals, sorted, disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip_intervals(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy_time(intervals, lo: int, hi: int) -> int:
    """Time inside [lo, hi) covered by at least one interval."""
    return sum(e - s for s, e in merge_intervals(
        clip_intervals(intervals, lo, hi)))


def idle_gaps(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in merge_intervals(clip_intervals(intervals, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_share_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def mfu_pct(flops_per_sample: float, samples: float, window_s: float,
            peak: float = PEAK_FLOPS_BF16) -> float:
    """Model FLOPs completed per second as a share of the peak, in %."""
    return 100.0 * flops_per_sample * samples / window_s / peak
