"""Read the program's own spans and counters (``omnihd_scenes_tpu_torch/
utils/timing.py``): the readers of the ``program_span`` and
``program_counter`` metrics switch the spans on for the traced window,
sum their device (or host) ms by name and read the window's counters.

A program without that store (an older commit) has nothing to read: the
readers then switch nothing on and report nothing.
"""

from __future__ import annotations

from typing import Optional


def store():
    """The program's span store, or None where it has none."""
    try:
        from omnihd_scenes_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, 'collect') else None


def attach(run) -> None:
    """Spans on, and what was recorded before the window forgotten (the
    program's set-up spans stay)."""
    timing = store()
    if timing is not None:
        timing.enable(True)
        timing.reset()


def spans() -> dict:
    timing = store()
    return {} if timing is None else timing.collect()['spans']


def counters() -> dict:
    """The program's counters over the window ({} where it has none)."""
    timing = store()
    return {} if timing is None else timing.collect()['counters']


def ms_a_call(run, *names: str, key: str = 'device_ms') -> Optional[float]:
    """The summed ``key`` of every span named in ``names`` over the
    window, a call; None where no such span was recorded."""
    found = spans()
    hits = [found[n][key] for n in names if n in found]
    return sum(hits) / run.window.requests if hits else None
