"""Multi-process sample preparation (counterpart of
``omnihd_scenes_tpu/data/worker_pool.py``).

Parity target: the reference's DataLoader worker processes
(``workers_per_gpu=4``, ``datasets/builder.py:72-103``): the six-image
undistort and the radar decode of a sample are host-CPU bound and must
overlap device compute.  The pool owns N ``spawn`` worker processes,
streams sample indices to them through a task queue, and yields prepared
samples *in submission order* with a bounded in-flight window
(``max(window, 2 * num_workers)``).  Each ``imap`` call is a generation:
results of an abandoned earlier iteration are dropped by their tag.  A
worker's exception is raised in the parent with its type and message.

Unlike the JAX package, a sample's arrays travel through shared memory:
the worker writes them all into one shared byte tensor and sends its
handle (``torch.multiprocessing`` queues) with their layout, and the
parent maps the same memory and gets NumPy views of it, so no array is
pickled (pickled-array IPC made the JAX package's 2-worker pool slower
than inline) and one handle crosses per sample.  Workers never
touch CUDA: each hides the devices (``CUDA_VISIBLE_DEVICES=''``) before it
runs the dataset.

NOTE: spawn re-imports ``__main__`` in each worker -- caller scripts must
guard their entry point with ``if __name__ == '__main__':`` (the CLIs and
``chip_smoke.py`` do).  The dataset must pickle: no open file, no CUDA
tensor.
"""

from __future__ import annotations

import os
import queue
import time
from typing import Dict, Iterable, Iterator

import numpy as np
import torch
import torch.multiprocessing as tmp

JOIN_SECONDS = 5.0


def reseed(dataset, worker_id: int) -> None:
    """The JAX package's per-worker reseed (``worker_pool.py:26-37``): every
    worker gets the same pickled ``dataset.rng``, so each draws a base from
    it and takes ``RandomState(base + worker_id)``; NumPy's global
    generator is reseeded from itself plus the worker id.  Which worker
    takes which index is a race, so draws differ from run to run, as in
    JAX."""
    if hasattr(dataset, 'rng') and isinstance(dataset.rng,
                                              np.random.RandomState):
        base = dataset.rng.randint(0, 2 ** 31 - 1)
        dataset.rng = np.random.RandomState(base + worker_id)
    np.random.seed((np.random.randint(0, 2 ** 31 - 1) + worker_id)
                   % (2 ** 31 - 1))


ALIGN = 64                              # bytes, each array's start


def _to_shared(sample):
    """A sample dict -> (one shared-memory byte tensor holding all its
    arrays, their layout, the other values): one handle crosses the queue
    per sample, not one per array."""
    if not isinstance(sample, dict):
        return None, [], sample
    arrays = {k: v for k, v in sample.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    layout, offset = [], 0
    for k, v in arrays.items():
        layout.append((k, v.dtype.str, v.shape, offset))
        offset += -(-v.nbytes // ALIGN) * ALIGN
    buf = torch.empty(max(offset, 1), dtype=torch.uint8).share_memory_()
    flat = buf.numpy()
    for (k, _, _, start), v in zip(layout, arrays.values()):
        flat[start:start + v.nbytes] = np.ascontiguousarray(v).reshape(
            -1).view(np.uint8)
    # The other values keep their places in the sample's key order.
    rest = {k: (v if k not in arrays else None) for k, v in sample.items()}
    return buf, layout, rest


def _from_shared(packed):
    """The sample: NumPy views of the shared arrays, in its key order."""
    buf, layout, rest = packed
    if buf is None:
        return rest
    flat = buf.numpy()
    for k, dtype, shape, start in layout:
        dtype = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        rest[k] = flat[start:start + n].view(dtype).reshape(shape)
    return rest


def _worker_main(dataset, worker_id, task_q, result_q):
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    reseed(dataset, worker_id)
    while True:
        item = task_q.get()
        if item is None:
            return
        gen, seq, idx = item
        try:
            sample = _to_shared(dataset[int(idx)])
        except BaseException as e:  # surface in the parent
            result_q.put((gen, seq, None, f'{type(e).__name__}: {e}'))
        else:
            result_q.put((gen, seq, sample, None))


class WorkerPool:
    """Ordered, bounded, multi-process index -> sample map."""

    def __init__(self, dataset, num_workers: int, window: int = 16):
        if num_workers <= 0:
            raise ValueError(f'num_workers must be positive, got '
                             f'{num_workers}')
        ctx = tmp.get_context('spawn')
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._window = max(window, 2 * num_workers)
        self._gen = 0
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(dataset, wid, self._task_q, self._result_q),
                        daemon=True)
            for wid in range(num_workers)]
        for p in self._procs:
            p.start()

    @property
    def window(self) -> int:
        return self._window

    def imap(self, indices: Iterable[int]) -> Iterator:
        """Yield ``dataset[i]`` for each i, in order; at most ``window``
        samples are submitted and not yet yielded."""
        self._gen += 1
        gen = self._gen
        it = iter(indices)
        pending: Dict[int, object] = {}
        submitted = consumed = 0
        exhausted = False
        while True:
            while not exhausted and submitted - consumed < self._window:
                try:
                    idx = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self._task_q.put((gen, submitted, int(idx)))
                submitted += 1
            if consumed == submitted and exhausted:
                return
            while consumed not in pending:
                rgen, seq, sample, err = self._result_q.get()
                if rgen != gen:
                    continue                  # stale: an earlier iteration
                if err is not None:
                    raise RuntimeError(f'data worker failed: {err}')
                pending[seq] = sample
            yield _from_shared(pending.pop(consumed))
            consumed += 1

    def close(self):
        """Stop the workers: each gets a stop task; results still queued
        are drained while they exit; any alive after ``JOIN_SECONDS`` is
        terminated."""
        for _ in self._procs:
            self._task_q.put(None)
        deadline = time.monotonic() + JOIN_SECONDS
        while any(p.is_alive() for p in self._procs) \
                and time.monotonic() < deadline:
            try:
                self._result_q.get(timeout=0.05)
            except (queue.Empty, OSError, EOFError):
                pass            # none queued, or its sender has exited
        for p in self._procs:
            p.join(timeout=0)
            if p.is_alive():
                p.terminate()
                p.join()
        self._procs = []

    def __del__(self):
        if getattr(self, '_procs', None):
            self.close()
