"""Threaded batch prefetching, and the pinned host-to-device feed
(counterpart of ``omnihd_scenes_tpu/data/prefetch.py``).

A background thread pulls batches from any iterator into a bounded queue;
the consumer gets them in order, and an exception of the producer is
raised in the consumer when it reaches it.  For a CUDA ``device`` the
thread also uploads each batch: it copies every array into pinned host
memory and moves it with ``train/loop.py:batch_to`` (``non_blocking``
copies) on a side stream, then records an event there.  The consumer makes
the current stream wait on that event (no host wait), and each uploaded
tensor is marked as used by the current stream, so the caching allocator
does not hand its memory to a later upload while the step still reads it;
PyTorch's pinned-memory allocator holds each pinned block until its copy
has completed.  ``batch_to``'s copies from pageable memory, as an
unprefetched step makes, are synchronous and overlap nothing.  A
device-decode batch's camera sources and augmentation records
(``image_loading.HOST_KEYS``: JPEG bytes, offsets, calibration, draws)
are pinned but stay on the host, where the entropy decode reads the
bitstreams; the thread then calls ``image_loading.decode_camera_batch`` on
the side stream, so the IDCT, ``rectify``, ``photometric`` and
``crop_resize_flip`` kernels of batch k + 1 run there while step k runs
(the native entropy decode releases the interpreter lock), and the event
is recorded after them: the consumer's wait and ``record_stream`` cover
the decoded ``imgs`` too.  For a CPU ``device`` the thread decodes such a
batch with the kernels' plain versions and passes every other batch
through; with no ``device`` batches pass through as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from omnihd_scenes_tpu_torch.data.image_loading import (HOST_KEYS,
                                                        decode_camera_batch)
from omnihd_scenes_tpu_torch.train.loop import batch_to


class PrefetchIterator:
    """Wraps any batch iterator with a background prefetch thread."""

    _SENTINEL = object()

    def __init__(self, iterable, buffer_size: int = 2,
                 device: Optional[torch.device] = None):
        self._iterable = iterable
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err = None
        self._device = None if device is None else torch.device(device)
        self._stream = None
        if self._device is not None and self._device.type == 'cuda':
            self._stream = torch.cuda.Stream(self._device)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _upload(self, batch):
        """``batch`` copied into pinned host memory, sent to the device by
        ``batch_to`` and its camera sources decoded on the side stream ->
        (device batch, the event after the copies and the decode)."""
        pinned = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v) for k, v in batch.items()}
        pinned = {k: (v.pin_memory() if torch.is_tensor(v) else v)
                  for k, v in pinned.items()}
        host = {k: pinned.pop(k) for k in HOST_KEYS if k in pinned}
        with torch.cuda.stream(self._stream):
            out = batch_to(pinned, self._device)
            out = decode_camera_batch({**out, **host}, self._device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            for item in self._iterable:
                if self._stream is not None:
                    item = self._upload(item)
                elif self._device is not None:
                    item = decode_camera_batch(item, self._device)
                self._q.put(item)
        except BaseException as e:  # propagate into the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        if self._stream is None:
            return item
        batch, event = item
        current = torch.cuda.current_stream(self._device)
        current.wait_event(event)
        for v in batch.values():
            if torch.is_tensor(v) and v.is_cuda:
                v.record_stream(current)
        return batch


def prefetch(iterable, buffer_size: int = 2,
             device: Optional[torch.device] = None) -> Iterator:
    """Prefetch batches from ``iterable`` on a background thread; with a
    CUDA ``device``, also upload them from pinned memory."""
    return PrefetchIterator(iterable, buffer_size, device)
