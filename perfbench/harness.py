"""One run of one cell: set up, measure for a fixed time, read the
metrics, check the outputs, and build the result line.

The driver of the cell (``perfbench/drivers/<family>_<kind>.py``) owns
the program and the reference; the harness owns the clock.  Set-up runs
from process start to the window's start: imports, seeded weights on the
device, the program's kernels (built in the checkout on its first run),
the traffic pool and the warm-up of every shape the window uses.  The
window is a closed loop: the next call starts when the previous one's
outputs are ready on the device.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from perfbench import manifest, profiling

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'omnihd_scenes_tpu')


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port must not
    import, compared whole (``omnihd_scenes_tpu_torch`` passes)."""
    return sorted({name for name in list(sys.modules)
                   if name.split('.')[0] in FORBIDDEN})


@dataclass
class Window:
    setup_s: float
    latencies_s: List[float] = field(default_factory=list)
    samples: int = 0
    window_s: float = 0.0

    @property
    def requests(self) -> int:
        return len(self.latencies_s)


@dataclass
class TraceRun:
    """What a per-layer metric's reader sees."""
    cell: manifest.Cell
    driver: object
    device: torch.device
    spans: profiling.Spans
    window: Optional[Window] = None
    timeline: Optional[profiling.Timeline] = None


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def measure(driver, device, seconds: float, setup_s: float,
            spans: Optional[profiling.Spans] = None) -> Window:
    """Call the driver back to back until ``seconds`` have passed; every
    call is timed from its start to its outputs being ready."""
    w = Window(setup_s)
    i = 0
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        t = time.perf_counter()
        w.samples += driver.request(i)
        if spans is not None:
            spans.mark('request_end')
        _sync(device)
        end = time.perf_counter()
        w.latencies_s.append(end - t)
        i += 1
    w.window_s = end - start
    return w


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> Dict:
    """One run; returns the result line (without the device's name)."""
    driver = manifest.driver(cell).Driver(cell, seed, device)
    driver.setup()
    _sync(device)
    run = TraceRun(cell, driver, device, profiling.Spans(device))
    readers = {}
    if trace:
        readers = {m['name']: manifest.metric(cell, m, per_layer=True)
                   for m in cell.per_layer}
        for reader in readers.values():
            if hasattr(reader, 'attach'):
                reader.attach(run)
    setup_s = time.perf_counter() - t0
    if trace:
        with profiling.profiler(device) as prof:
            with torch.profiler.record_function(profiling.WINDOW):
                run.window = measure(driver, device, seconds, setup_s,
                                     run.spans)
        run.timeline = profiling.Timeline(prof)
        del prof
    else:
        run.window = measure(driver, device, seconds, setup_s)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)

    metrics = {}
    entries = cell.per_layer if trace else cell.end_to_end
    for m in entries:
        reader = (readers[m['name']] if trace else
                  manifest.metric(cell, m, per_layer=False))
        value = reader.read(run if trace else run.window)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    run.spans.remove()
    device_info = {'memory_peak_bytes': int(peak)}
    line = {'correct': None, 'attempted': run.window.requests, 'failed': 0,
            'metrics': metrics, 'device': device_info}
    if trace:
        device_info['busy_s'] = run.timeline.busy_s()
        device_info['window_s'] = run.timeline.window_s
        line['breakdown'] = run.timeline.breakdown()
        run.timeline = None

    driver.release()
    numbers = driver.check()
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = cell.limits.get(name, {}).get('limit')
        ok = limit is not None and value <= limit
        correct = correct and ok
        checks[name] = {'value': value, 'limit': limit}
    line['correct'] = bool(correct and checks)
    line['checks'] = checks
    return line
