"""The port's host feed on the CPU: the worker pool (``data/worker_pool.py``),
the prefetch (``data/prefetch.py``) and the native radar decode
(``data/native.py`` + ``csrc/host_ops.cpp``).

* the pool: samples in submission order, at most ``window`` indices
  taken ahead of the consumer, results of an abandoned iteration dropped
  by generation, a worker's exception raised in the parent with its type
  and message, ``close`` stopping every worker; the per-worker reseed is
  the JAX package's formula; arrays arrive as NumPy over shared memory;
* ``TrainLoader(num_workers=2)`` gives the inline loader's batches bit for
  bit on a radar dataset without ``aug`` (the dataset draws nothing from
  its rng, which the pool reseeds per worker);
* the prefetch keeps order, re-raises a producer's error in the consumer,
  passes batches through for a CPU device, and bounds its buffer;
* native radar rows are bit-equal to the JAX package's native rows (its
  library built from its own source into a private directory, so no
  parallel test sees a partial build) and within 1e-6 of a row's largest
  value of the NumPy rows (the C++ computes in f64 where NumPy's
  trigonometry runs on f32 arrays); the port's dataset on its default
  (native) path is bit-equal to JAX's on its default; a sweep that cannot
  be read raises.

The JAX package is imported only inside the tests that compare with it:
the spawn workers import this module.
"""

import os
import pickle
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.data import native
from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
from omnihd_scenes_tpu_torch.data.loader import TrainLoader
from omnihd_scenes_tpu_torch.data.prefetch import prefetch
from omnihd_scenes_tpu_torch.data.radar_loading import load_radar_sweep
from omnihd_scenes_tpu_torch.data.worker_pool import WorkerPool, reseed
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ToyDataset:
    """Index-identifiable samples (module-level: spawn workers unpickle
    it)."""

    def __init__(self, n=40):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {'idx': np.array([idx], np.int64),
                'x': np.full((3, 4), float(idx), np.float32),
                'mask': np.arange(5) < idx % 5,
                'index': np.int32(idx)}


class BadDataset(ToyDataset):
    def __getitem__(self, idx):
        if idx == 3:
            raise KeyError('boom at 3')
        return super().__getitem__(idx)


class CountingIndices:
    """An index iterator that counts how many indices were taken."""

    def __init__(self, n):
        self.taken = 0
        self._it = iter(range(n))

    def __iter__(self):
        return self

    def __next__(self):
        idx = next(self._it)
        self.taken += 1
        return idx


@pytest.fixture(scope='module')
def pool():
    p = WorkerPool(ToyDataset(), num_workers=2, window=6)
    yield p
    p.close()


def test_pool_order_and_window(pool):
    assert pool.window == 6
    indices = CountingIndices(40)
    it = pool.imap(indices)
    got = []
    for _ in range(5):
        got.append(next(it))
        # never more than `window` submitted and not yet yielded
        assert indices.taken - (len(got) - 1) <= pool.window
    got.extend(it)
    assert [int(s['idx'][0]) for s in got] == list(range(40))
    s = got[7]
    assert isinstance(s['x'], np.ndarray) and s['x'].dtype == np.float32
    assert s['mask'].dtype == np.bool_ and int(s['index']) == 7
    np.testing.assert_array_equal(s['x'], np.full((3, 4), 7.0, np.float32))


def test_pool_drops_a_stale_generation(pool):
    it = pool.imap(range(32))
    for _ in range(3):                 # consume a few, abandon the rest
        next(it)
    del it
    got = [int(s['idx'][0]) for s in pool.imap(range(16, 24))]
    assert got == list(range(16, 24))


def test_pool_raises_a_worker_error_and_closes():
    p = WorkerPool(BadDataset(8), num_workers=1)
    procs = list(p._procs)
    try:
        with pytest.raises(RuntimeError, match=r"KeyError: 'boom at 3'"):
            list(p.imap(range(8)))
    finally:
        t0 = time.monotonic()
        p.close()
    assert time.monotonic() - t0 < 10
    assert not any(proc.is_alive() for proc in procs)
    assert p._procs == []


class RngDataset:
    def __init__(self):
        self.rng = np.random.RandomState(0)


def test_reseed_formula():
    """The JAX package's formula (``worker_pool.py:26-37``) in process."""
    ds = RngDataset()
    base = np.random.RandomState(0).randint(0, 2 ** 31 - 1)
    np.random.seed(123)
    glob = np.random.randint(0, 2 ** 31 - 1)
    np.random.seed(123)
    reseed(ds, worker_id=3)
    np.testing.assert_array_equal(
        ds.rng.get_state()[1], np.random.RandomState(base + 3).get_state()[1])
    want = np.random.RandomState((glob + 3) % (2 ** 31 - 1)).rand(4)
    np.testing.assert_array_equal(np.random.rand(4), want)


@pytest.fixture(scope='module')
def infos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('feed'))
    generate(root, 'v1.0-mini', SyntheticConfig(
        n_scenes=2, samples_per_scene=5, n_lidar_points=256,
        n_radar_points=96), images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def _dataset(infos):
    """Room for every point and no shuffle: the rng is never drawn."""
    return NewScenesDetDataset(
        ann_file=os.path.join(infos, 'synth_infos_temporal_train.pkl'),
        modality='radar', max_points=4000, max_gt=16, radar_sweeps=3)


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_loader_with_workers_equals_inline(infos):
    ds = _dataset(infos)
    loader = TrainLoader(ds, 3, seed=2, num_workers=2)
    try:
        got = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            got.extend(loader)
    finally:
        loader.close()
    inline = TrainLoader(ds, 3, seed=2)
    want = []
    for epoch in range(2):
        inline.set_epoch(epoch)
        want.extend(inline)
    assert len(got) == len(want) == 2 * len(inline) >= 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_prefetch_order_error_and_bound():
    assert list(prefetch(iter(range(20)), buffer_size=4)) == list(range(20))
    batches = [{'x': np.full(3, i, np.float32)} for i in range(5)]
    got = list(prefetch(iter(batches), device=torch.device('cpu')))
    assert all(g is b for g, b in zip(got, batches))   # passed through

    def gen():
        yield 1
        raise ValueError('boom')

    it = prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match='boom'):
        next(it)

    produced = []
    started = threading.Event()

    def slow():
        for i in range(10):
            produced.append(i)
            started.set()
            yield i

    it = prefetch(slow(), buffer_size=2)
    started.wait(5)
    time.sleep(0.2)
    # two in the buffer, one more held by the blocked producer
    assert len(produced) <= 3
    assert list(it) == list(range(10))


def _sweeps(infos):
    with open(os.path.join(infos, 'synth_infos_temporal_train.pkl'),
              'rb') as f:
        infos_ = pickle.load(f)['infos']
    return [(key, s, int(sweeps[0]['timestamp']) * 1e-6)
            for info in infos_[:3] for key, sweeps in info['radars'].items()
            for s in sweeps]


@pytest.fixture()
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native library, built from its own source into
    ``tmp_path``."""
    from omnihd_scenes_tpu.data import native as jax_native

    shutil.copy(os.path.join(ROOT, 'csrc', 'host_ops.cpp'), tmp_path)
    monkeypatch.setattr(jax_native, '_CSRC', str(tmp_path))
    monkeypatch.setattr(jax_native, '_LIB', None)
    monkeypatch.setattr(jax_native, '_TRIED', False)
    assert jax_native.get_lib() is not None
    return jax_native


def test_native_rows(infos, jax_native):
    from omnihd_scenes_tpu.data.radar_loading import (
        load_radar_sweep as jax_load_radar_sweep)

    sweeps = _sweeps(infos)
    assert len(sweeps) >= 18
    for key, sweep, ref_ts in sweeps:
        got = load_radar_sweep(sweep, key, ref_ts=ref_ts)
        want = jax_load_radar_sweep(sweep, key, ref_ts=ref_ts)
        assert got.dtype == want.dtype == np.float32 and len(got) > 0
        np.testing.assert_array_equal(got, want)
        rows = load_radar_sweep(sweep, key, ref_ts=ref_ts, use_native=False)
        np.testing.assert_allclose(got, rows, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(rows).max())))


def test_native_dataset_equals_jax(infos, jax_native):
    from omnihd_scenes_tpu.data.dataset import (
        NewScenesDetDataset as JaxDataset)

    ann = os.path.join(infos, 'synth_infos_temporal_train.pkl')
    kw = dict(modality='radar', max_points=300, max_gt=16, radar_sweeps=3,
              point_shuffle=True)
    want_ds, got_ds = JaxDataset(ann_file=ann, **kw), NewScenesDetDataset(
        ann_file=ann, **kw)
    for i in range(len(want_ds)):
        _assert_batches_equal(got_ds[i], want_ds[i])


def test_unreadable_sweep_raises(tmp_path):
    with pytest.raises(OSError):
        native.radar_sweep_native(str(tmp_path / 'missing.bin'), np.eye(3),
                                  np.eye(3), np.zeros(3), np.zeros(3), 0.0,
                                  0.0)
