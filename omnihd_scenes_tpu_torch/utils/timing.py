"""Spans, counters and device traces (counterpart of
``omnihd_scenes_tpu/utils/timing.py``).

Parity targets: the reference's ``run_time`` perf_counter decorator
(``models/utils/bricks.py:7-20``) and the commented-out mmcv
profiler-hook (``apis/mmdet_train.py:149-152``); the JAX package traces
with ``jax.profiler``, the port with ``torch.profiler`` into a Chrome
trace (open it in ``chrome://tracing`` or Perfetto).

The port's layers open named spans (``with span('serve.upload'):`` or
``@span('msda')``) and add to named counters (``count('serve.samples',
b)``).  Spans are off by default: a span then costs one check of a
module flag, and makes no profiler range, no CUDA event and no
allocation.  ``enable(True)`` turns them on: each span then opens
``torch.profiler.record_function('omnihd.<name>')`` (a range on the
profiler's own host clock, the clock of its device trace) and records in
memory its name, an id, the id of the span it opened under (a
thread-local stack), a request id shared by every span under one root
span, its host start and end (``time.perf_counter_ns``) and, where CUDA
is available, a pair of timing events on the current stream.  Nothing is
written out: :func:`collect` synchronises once and sums the spans by
name.  A span does nothing while ``torch.compile`` / ``torch.export``
trace (an exported program holds no profiler op), while a CUDA graph is
captured, and inside the autograd engine's backward (a rematerialised
forward is counted under the span that runs the backward).  Set-up spans
(names ``setup.*``, a few a process) and :func:`run_time` record their
host time even when spans are off.  Counters are always on.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from functools import wraps
from typing import Dict, List, Optional

import torch

PREFIX = 'omnihd.'
SETUP = 'setup.'

_ON = False          # spans switched on (enable)
_CUDA = False        # ... and timing CUDA events on the current stream
_OPEN = 0            # frames open, on any thread
_LOCAL = threading.local()
_IDS = itertools.count(1)
_RECORDS: List['Record'] = []
_COUNTERS: Dict[str, int] = defaultdict(int)


class Record:
    """One finished span: ``name``, ``span_id``, ``parent_id`` (None for a
    root), ``request_id`` (its root's ``span_id``), ``host_ms`` and, once
    collected, ``device_ms`` (the host time where no CUDA events were
    recorded: the CPU runs its work as it is issued)."""

    __slots__ = ('span', 'name', 'span_id', 'parent_id', 'request_id', 't0',
                 't1', 'start', 'end', 'range', 'device_ms')

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class Span:
    """A named span; :func:`span` gives the one object of each name.  Use
    it as a context manager or as a decorator."""

    __slots__ = ('name', 'always')

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always or name.startswith(SETUP)

    def __enter__(self):
        if _ON or self.always:
            _open(self)
        return self

    def __exit__(self, *exc):
        if _OPEN:
            _close(self)
        return False

    def __call__(self, fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapper


_SPANS: Dict[str, Span] = {}


def span(name: str) -> Span:
    """The span ``name`` (made once, then looked up)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = Span(name)
    return s


def _stack() -> list:
    stack = getattr(_LOCAL, 'stack', None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _open(s: Span) -> None:
    global _OPEN
    if (torch.compiler.is_compiling()
            or torch._C._current_graph_task_id() != -1):
        return                       # traced, or the autograd backward
    events = _ON and _CUDA
    if events and torch.cuda.is_current_stream_capturing():
        return
    stack = _stack()
    r = Record()
    r.span, r.name, r.span_id = s, s.name, next(_IDS)
    parent = stack[-1] if stack else None
    r.parent_id = None if parent is None else parent.span_id
    r.request_id = r.span_id if parent is None else parent.request_id
    r.range = r.start = r.end = r.device_ms = None
    r.t0 = time.perf_counter_ns()       # the host time holds the range
    if _ON:
        r.range = torch.autograd.profiler.record_function(PREFIX + s.name)
        r.range.__enter__()
    if events:
        r.start = torch.cuda.Event(enable_timing=True)
        r.start.record()
    stack.append(r)
    _OPEN += 1


def _close(s: Span) -> None:
    global _OPEN
    if torch.compiler.is_compiling():
        return
    stack = _stack()
    if not stack or stack[-1].span is not s:
        return                       # not opened: a no-op case of _open
    r = stack.pop()
    _OPEN -= 1
    if r.start is not None:
        r.end = torch.cuda.Event(enable_timing=True)
        r.end.record()
    if r.range is not None:
        r.range.__exit__(None, None, None)
        r.range = None
    r.t1 = time.perf_counter_ns()
    _RECORDS.append(r)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on; not while tracing a
    program for ``torch.compile`` / ``torch.export``)."""
    if not torch.compiler.is_compiling():
        _COUNTERS[name] += n


def enable(flag: bool = True) -> None:
    """Switch the spans on or off (set-up spans, :func:`run_time` and the
    counters record either way)."""
    global _ON, _CUDA
    _ON = bool(flag)
    _CUDA = _ON and torch.cuda.is_available()


def enabled() -> bool:
    return _ON


def reset(setup: bool = False) -> None:
    """Forget every span recorded so far and every counter.  The set-up
    spans, recorded once a process before any measured window, are kept
    unless ``setup``."""
    _RECORDS[:] = [] if setup else [r for r in _RECORDS
                                    if r.name.startswith(SETUP)]
    _COUNTERS.clear()


def records() -> List[Record]:
    """The finished spans, in the order they ended, their device times
    resolved (one synchronisation if any event is pending)."""
    pending = [r for r in _RECORDS if r.device_ms is None]
    if any(r.start is not None for r in pending):
        torch.cuda.synchronize()
    for r in pending:
        r.device_ms = (r.start.elapsed_time(r.end) if r.start is not None
                       else r.host_ms)
        r.start = r.end = None
    return list(_RECORDS)


def collect() -> dict:
    """``{'spans': {name: {'calls', 'host_ms', 'device_ms',
    'self_device_ms'}}, 'counters': {name: n}}``: each span name's sums
    over the spans recorded since :func:`reset`; a span's self time is its
    device time less its child spans' device time."""
    recs = records()
    children = defaultdict(float)
    for r in recs:
        if r.parent_id is not None:
            children[r.parent_id] += r.device_ms
    spans: Dict[str, dict] = {}
    for r in recs:
        s = spans.setdefault(r.name, {'calls': 0, 'host_ms': 0.0,
                                      'device_ms': 0.0,
                                      'self_device_ms': 0.0})
        s['calls'] += 1
        s['host_ms'] += r.host_ms
        s['device_ms'] += r.device_ms
        s['self_device_ms'] += r.device_ms - children[r.span_id]
    return {'spans': spans, 'counters': dict(_COUNTERS)}


def children_ms(root: str, recs: Optional[List[Record]] = None) -> dict:
    """{name: device ms} of the spans opened directly under spans named
    ``root``, in the order they first ended, and ``root`` itself."""
    recs = records() if recs is None else recs
    roots = {r.span_id for r in recs if r.name == root}
    out: Dict[str, float] = {}
    for r in recs:
        if r.parent_id in roots:
            out[r.name] = out.get(r.name, 0.0) + r.device_ms
    out[root] = sum(r.device_ms for r in recs if r.span_id in roots)
    return out


def run_time(name: str) -> Span:
    """Decorator: accumulate host-side wall time under ``name`` (a span
    that records its host time whether or not spans are on)."""
    return Span(name, always=True)


def timing_stats() -> dict:
    """{name: {'total_s', 'calls', 'mean_ms'}} over the recorded spans'
    host times."""
    out = {}
    for name, v in collect()['spans'].items():
        out[name] = {'total_s': v['host_ms'] / 1e3, 'calls': v['calls'],
                     'mean_ms': v['host_ms'] / max(v['calls'], 1)}
    return out


def reset_timing_stats():
    reset(setup=True)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block, CPU activities and, where a GPU
    is present, CUDA ones, with the spans on (the trace shows the
    ``omnihd.*`` ranges); on exit the trace is written into ``logdir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format).  Yields the profiler
    (``key_averages()`` and so on)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = enabled()
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))
