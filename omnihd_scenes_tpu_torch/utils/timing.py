"""Profiling helpers (counterpart of ``omnihd_scenes_tpu/utils/timing.py``).

Parity targets: the reference's ``run_time`` perf_counter decorator
(``models/utils/bricks.py:7-20``) and the commented-out mmcv
profiler-hook (``apis/mmdet_train.py:149-152``); the JAX package traces
with ``jax.profiler``, the port with ``torch.profiler`` into a Chrome
trace (open it in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from functools import wraps

_STATS = defaultdict(lambda: [0.0, 0])


def run_time(name: str):
    """Decorator: accumulate host-side wall time under ``name``."""

    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            _STATS[name][0] += dt
            _STATS[name][1] += 1
            return out

        return wrapper

    return deco


def timing_stats() -> dict:
    return {k: {'total_s': v[0], 'calls': v[1],
                'mean_ms': v[0] / max(v[1], 1) * 1e3}
            for k, v in _STATS.items()}


def reset_timing_stats():
    _STATS.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block, CPU activities and, where a GPU
    is present, CUDA ones; on exit the trace is written into ``logdir``
    as ``trace_<pid>_<ns>.json`` (Chrome trace format).  Yields the
    profiler (``key_averages()`` and so on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))
