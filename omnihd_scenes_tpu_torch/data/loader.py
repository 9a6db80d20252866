"""Host-side batching: shuffled training batches and rank-contiguous
eval sharding.

Parity targets: the reference's ``DistributedGroupSampler``
(shuffled, padded training sampler, ``samplers/group_sampler.py:61-104``)
and the contiguous-block ``DistributedSampler``
(``samplers/distributed_sampler.py:35-37``) whose per-rank temporal
continuity the streaming BEVFormer eval depends on.  Here "ranks" are
data-parallel shards of one host batch; multi-host keeps the same
contiguous-block rule per process.

Restated from ``omnihd_scenes_tpu/data/loader.py``: the same seeded epoch
order and padding, hence the same batches; batches are NumPy dicts, which
``data/prefetch.py`` (or ``train/loop.py:batch_to``) moves to the device.
A device-decode sample's JPEG bytes (``image_loading.camera_sources``;
a temporal queue's frames already concatenated, with (T, N + 1) offsets)
are concatenated across the batch, not stacked, and their offsets
rebased; the augmentation records stack like any array.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from omnihd_scenes_tpu_torch.data.image_loading import (JPEG_BYTES,
                                                        JPEG_OFFSETS,
                                                        collate_jpeg)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack each key; a device-decode sample's ragged JPEG bytes are
    concatenated instead, with their offsets rebased (``collate_jpeg``)."""
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]
           if k not in (JPEG_BYTES, JPEG_OFFSETS)}
    if JPEG_BYTES in samples[0]:
        out.update(collate_jpeg(samples))
    return out


class TrainLoader:
    """Epoch-shuffled, padded batch iterator (drop_last=False).

    ``group_flags`` switches to the reference's group-aware shuffle
    (``DistributedGroupSampler`` semantics: group-pure batches).
    ``num_workers > 0`` prepares samples in that many spawn processes
    (``data/worker_pool.py``; reference ``workers_per_gpu``,
    ``datasets/builder.py:72-103``); :meth:`close` stops them.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, num_workers: int = 0,
                 group_flags: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self.group_flags = (None if group_flags is None
                            else np.asarray(group_flags))
        self._pool = None
        if num_workers > 0:
            from omnihd_scenes_tpu_torch.data.worker_pool import WorkerPool

            self._pool = WorkerPool(dataset, num_workers,
                                    window=max(16, 2 * batch_size))

    def __len__(self):
        if self.group_flags is not None and self.shuffle:
            # Group-aware padding: each group padded to a batch multiple.
            total = sum(
                -(-int((self.group_flags == g).sum()) // self.batch_size)
                for g in np.unique(self.group_flags))
            return total
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            order = np.arange(n)
        elif self.group_flags is not None:
            from omnihd_scenes_tpu_torch.data.sampling import group_shuffled_order

            return group_shuffled_order(
                self.group_flags, self.batch_size,
                np.random.RandomState(self.seed + self.epoch))
        else:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(n)
        # Pad to a full final batch by wrapping (reference group sampler
        # pads with repeated indices).
        pad = (-n) % self.batch_size
        return np.concatenate([order, order[:pad]])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        if self._pool is not None:
            batch: List = []
            for s in self._pool.imap(order):
                batch.append(s)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            return
        for i in range(0, len(order), self.batch_size):
            idxs = order[i:i + self.batch_size]
            yield collate([self.dataset[int(j)] for j in idxs])

    def close(self):
        """Stop the worker processes, if any."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None


class EvalLoader:
    """Contiguous-block eval iterator.

    Keeps temporally adjacent samples in the same shard position so a
    streaming (stateful) model sees each scene in order, mirroring the
    reference's contiguous DistributedSampler.  Yields (batch, valid)
    where ``valid`` marks real (non-padded) samples.
    """

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        num_batches = len(self)
        per_slot = num_batches  # contiguous block per batch slot
        for b in range(num_batches):
            samples, valid = [], []
            for slot in range(self.batch_size):
                idx = slot * per_slot + b
                if idx < n:
                    samples.append(self.dataset[idx])
                    valid.append(True)
                else:
                    samples.append(self.dataset[n - 1])  # pad with last
                    valid.append(False)
            yield collate(samples), np.asarray(valid)
