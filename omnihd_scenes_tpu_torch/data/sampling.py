"""Training samplers and dataset wrappers.

Parity targets:
  * ``DistributedGroupSampler`` (reference
    ``datasets/samplers/group_sampler.py:61-104``): shuffle within
    sample groups, pad each group to a batch multiple with repeated
    indices, then shuffle whole batches — every batch is group-pure.
  * ``custom_build_dataset`` wrappers (reference
    ``datasets/builder.py:125-148``): ``RepeatDataset``,
    ``ConcatDataset``, ``ClassBalancedDataset`` (mmdet
    oversample_thr repeat factors) and ``CBGSDataset`` (mmdet3d
    class-balanced grouping-and-sampling, arXiv:1908.09492).

Wrappers forward attribute access to the base dataset so loaders and
eval code see the same interface.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def group_shuffled_order(flags: np.ndarray, batch_size: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """Group-aware shuffled index order (one epoch).

    Within each group: shuffle, pad to a multiple of ``batch_size`` by
    repeating randomly chosen members; then shuffle the batch blocks
    globally.  Mirrors the reference sampler's semantics with
    ``samples_per_gpu = batch_size``.
    """
    flags = np.asarray(flags)
    blocks: List[np.ndarray] = []
    for g in np.unique(flags):
        idx = np.where(flags == g)[0]
        idx = rng.permutation(idx)
        pad = (-len(idx)) % batch_size
        if pad:
            idx = np.concatenate([idx, rng.choice(idx, pad)])
        blocks.extend(idx[i:i + batch_size]
                      for i in range(0, len(idx), batch_size))
    order = rng.permutation(len(blocks))
    return np.concatenate([blocks[i] for i in order]) if blocks else \
        np.zeros((0,), np.int64)


class _Wrapper:
    """Attribute-forwarding base for dataset wrappers."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getattr__(self, name):
        # Guard against pickling-time lookups before __init__ ran
        # (spawn workers unpickle the wrapper; unconditional delegation
        # recurses forever on the missing 'dataset').
        if name.startswith('__') or 'dataset' not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.dataset, name)


class RepeatDataset(_Wrapper):
    """Reference ``RepeatDataset``: dataset repeated ``times`` times."""

    def __init__(self, dataset, times: int):
        super().__init__(dataset)
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


class ConcatDataset:
    """Reference ``ConcatDataset``: chain several datasets."""

    def __init__(self, datasets: Sequence):
        assert datasets
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __getattr__(self, name):
        if name.startswith('__') or 'datasets' not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.datasets[0], name)

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self._offsets, idx, side='right'))
        prev = 0 if ds == 0 else int(self._offsets[ds - 1])
        return self.datasets[ds][idx - prev]


def _sample_cat_ids(dataset, idx: int) -> List[int]:
    """Class ids present in sample ``idx`` (from the info dict)."""
    if hasattr(dataset, 'get_cat_ids'):
        return list(dataset.get_cat_ids(idx))
    info = dataset.infos[idx]
    name_to_id = {n: i for i, n in enumerate(dataset.classes)}
    return sorted({name_to_id[n] for n in info['gt_names']
                   if n in name_to_id})


class ClassBalancedDataset(_Wrapper):
    """mmdet ``ClassBalancedDataset``: per-sample repeat factor
    ``max(1, sqrt(oversample_thr / f_c))`` over the rarest category in
    the sample, where f_c is the category frequency."""

    def __init__(self, dataset, oversample_thr: float = 1e-3):
        super().__init__(dataset)
        n = len(dataset)
        cat_freq: Dict[int, float] = {}
        sample_cats = [_sample_cat_ids(dataset, i) for i in range(n)]
        for cats in sample_cats:
            for c in cats:
                cat_freq[c] = cat_freq.get(c, 0) + 1
        for c in cat_freq:
            cat_freq[c] /= n
        repeat = {c: max(1.0, math.sqrt(oversample_thr / f))
                  for c, f in cat_freq.items()}
        indices: List[int] = []
        for i, cats in enumerate(sample_cats):
            r = max([repeat[c] for c in cats], default=1.0)
            indices.extend([i] * int(math.ceil(r)))
        self.indices = np.asarray(indices, np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]


class CBGSDataset(_Wrapper):
    """mmdet3d ``CBGSDataset`` (class-balanced grouping and sampling):
    resample so every class contributes ~equally — for each class,
    draw ``ceil(total/num_classes)`` sample indices (with replacement)
    from the samples containing that class."""

    def __init__(self, dataset, seed: int = 0):
        super().__init__(dataset)
        n = len(dataset)
        num_classes = len(dataset.classes)
        class_samples: Dict[int, List[int]] = {c: []
                                               for c in range(num_classes)}
        for i in range(n):
            for c in _sample_cat_ids(dataset, i):
                class_samples[c].append(i)
        rng = np.random.RandomState(seed)
        target = int(math.ceil(
            sum(len(v) for v in class_samples.values()) / num_classes))
        indices: List[int] = []
        for c, samples in class_samples.items():
            if not samples:
                continue
            take = rng.choice(samples, target, replace=True)
            indices.extend(int(i) for i in take)
        self.indices = np.asarray(indices if indices else range(n),
                                  np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]


def wrap_dataset(dataset, wrapper: Optional[Dict] = None):
    """Config-driven wrapper construction (reference
    ``custom_build_dataset`` dispatch)."""
    if not wrapper:
        return dataset
    if isinstance(wrapper, str):
        # --cfg-options data.train.wrapper=CBGSDataset shorthand
        wrapper = {'type': wrapper}
    kind = wrapper.get('type')
    if kind == 'RepeatDataset':
        return RepeatDataset(dataset, int(wrapper.get('times', 1)))
    if kind == 'ClassBalancedDataset':
        return ClassBalancedDataset(
            dataset, float(wrapper.get('oversample_thr', 1e-3)))
    if kind == 'CBGSDataset':
        return CBGSDataset(dataset, int(wrapper.get('seed', 0)))
    raise ValueError(f'unknown dataset wrapper {kind!r}')
