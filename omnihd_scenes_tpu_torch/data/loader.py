"""Host-side batching: shuffled training batches and rank-contiguous
eval sharding.

Parity targets: the reference's ``DistributedGroupSampler``
(shuffled, padded training sampler, ``samplers/group_sampler.py:61-104``)
and the contiguous-block ``DistributedSampler``
(``samplers/distributed_sampler.py:35-37``) whose per-rank temporal
continuity the streaming BEVFormer eval depends on.  Here "ranks" are
data-parallel shards of one host batch; multi-host keeps the same
contiguous-block rule per process.  With ``world_size`` W > 1 (one
rank a process, ``parallel/``), :class:`TrainLoader` draws the JAX
package's epoch order over the global batch and yields rank r's rows of
each, and :class:`EvalLoader` walks rank r's contiguous block of the
dataset.

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

    ``batch_size`` is the global batch.  With ``world_size`` W > 1 it
    splits into W rows of ``batch_size / W``: rank ``rank`` prepares and
    yields only rows ``[r n, (r + 1) n)`` of each global batch (JAX's
    ``NamedSharding(P('data'))`` split of the same batch), and ``len()``
    still counts global batches.  Its workers reseed with ids offset by
    ``rank * num_workers``; with no workers the dataset's ``rng`` is
    reseeded as worker ``rank`` would be, so ranks draw different
    augmentations.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, num_workers: int = 0,
                 group_flags: Optional[np.ndarray] = None,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f'global batch {batch_size} does not split '
                             f'over {world_size} ranks')
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self.group_flags = (None if group_flags is None
                            else np.asarray(group_flags))
        self._pool = None
        local = batch_size // world_size
        if num_workers > 0:
            from omnihd_scenes_tpu_torch.data.worker_pool import WorkerPool

            self._pool = WorkerPool(dataset, num_workers,
                                    window=max(16, 2 * local),
                                    first_worker_id=rank * num_workers)
        elif world_size > 1:
            from omnihd_scenes_tpu_torch.data.worker_pool import reseed

            reseed(dataset, rank)

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
        # This rank's rows of each global batch of the epoch order.
        local = self.batch_size // self.world_size
        order = self._epoch_order().reshape(-1, self.batch_size)[
            :, self.rank * local:(self.rank + 1) * local].reshape(-1)
        if self._pool is not None:
            batch: List = []
            for s in self._pool.imap(order):
                batch.append(s)
                if len(batch) == local:
                    yield collate(batch)
                    batch = []
            return
        for i in range(0, len(order), local):
            idxs = order[i:i + local]
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

    With ``world_size`` W > 1, rank r walks only its block, ``block``:
    the reference's ``DistributedSampler`` without shuffling
    (``samplers/distributed_sampler.py:35-37``), ceil(n / W) indices from
    ``r ceil(n / W)`` on, the dataset's order wrapped to fill the last
    block, so every rank holds as many samples; the ranks' blocks in
    rank order, trimmed to n, are the dataset.
    """

    def __init__(self, dataset, batch_size: int, rank: int = 0,
                 world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        n = len(dataset)
        per_rank = -(-n // world_size)
        order = np.arange(per_rank * world_size) % max(n, 1)
        self.block = order[rank * per_rank:(rank + 1) * per_rank]

    def __len__(self):
        return (len(self.block) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.block)
        num_batches = len(self)
        per_slot = num_batches  # contiguous block per batch slot
        for b in range(num_batches):
            samples, valid = [], []
            for slot in range(self.batch_size):
                pos = slot * per_slot + b
                if pos < n:
                    samples.append(self.dataset[int(self.block[pos])])
                    valid.append(True)
                else:                               # pad with last
                    samples.append(self.dataset[int(self.block[n - 1])])
                    valid.append(False)
            yield collate(samples), np.asarray(valid)
