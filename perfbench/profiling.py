"""What a traced run reads: device timelines from ``torch.profiler``
(Kineto's raw events), CUDA-event spans on module hooks, and the
breakdown of the device's busy and idle time.

Nothing here runs unless ``--trace 1``; the end-to-end metrics come from
runs without it.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from perfbench import stats

WINDOW = 'perfbench.window'
# How far back from a gap to look for the host operation enclosing it.
_SCAN_BACK = 4000


class _HostEvent:
    """A stand-in for a CUDA event on the CPU (tests at a tiny size)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Device-time spans: CUDA events recorded around module calls
    (forward pre- and post-hooks) or at points the harness marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.pairs: Dict[str, List[Tuple]] = defaultdict(list)
        self.marks: Dict[str, List] = defaultdict(list)
        self._open: Dict[str, object] = {}
        self._handles = []

    def event(self):
        e = (torch.cuda.Event(enable_timing=True) if self.cuda
             else _HostEvent())
        e.record()
        return e

    def module(self, key: str, module: torch.nn.Module) -> None:
        """Time every call of ``module`` under ``key``."""
        def pre(mod, args):
            self._open[key] = self.event()

        def post(mod, args, out):
            self.pairs[key].append((self._open.pop(key), self.event()))
        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def after(self, key: str, module: torch.nn.Module) -> None:
        """Mark the end of every call of ``module`` under ``key``."""
        self._handles.append(module.register_forward_hook(
            lambda mod, args, out: self.mark(key)))

    def mark(self, key: str) -> None:
        self.marks[key].append(self.event())

    def total_ms(self, key: str) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs[key])

    def between_ms(self, first: str, second: str) -> float:
        """Sum over the i-th marks of ``first`` and ``second``."""
        return sum(a.elapsed_time(b) for a, b in zip(self.marks[first],
                                                     self.marks[second]))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Timeline:
    """The profiler's events of the traced window, in ns on one clock:
    ``device`` (name, start, end) for kernels, copies and fills;
    ``host`` (name, start, end) for everything the CPU recorded."""

    def __init__(self, prof):
        device, host = [], []
        lo = hi = None
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation() and e.name() != WINDOW:
                    device.append((e.name(), start, end))
            else:
                host.append((e.name(), start, end))
                if e.name() == WINDOW:
                    lo, hi = start, end
        if lo is None:
            raise RuntimeError(f'the trace holds no {WINDOW!r} range')
        self.lo, self.hi = lo, hi
        self.device = [d for d in device if d[2] > lo and d[1] < hi]
        host.sort(key=lambda h: h[1])
        self.host = host
        self._starts = [h[1] for h in host]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return stats.busy_time([(s, e) for _, s, e in self.device],
                               self.lo, self.hi) / 1e9

    def device_s(self, match) -> Tuple[float, int]:
        """(seconds, launches) of the device events whose name
        ``match(name)`` accepts."""
        hits = [(s, e) for n, s, e in self.device if match(n)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - _SCAN_BACK, -1), -1):
            name, s, e = self.host[j]
            if e > t and name != WINDOW:
                return name
        return 'host (no recorded operation)'

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(int)
        for n, s, e in self.device:
            by_op[n] += min(e, self.hi) - max(s, self.lo)
        gaps = defaultdict(int)
        for s, e in stats.idle_gaps([(s, e) for _, s, e in self.device],
                                    self.lo, self.hi):
            gaps[self.host_at((s + e) // 2)] += e - s

        def ranked(d):
            return [[k, v / 1e9] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': ranked(by_op), 'idle_gaps': ranked(gaps)}


def profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
