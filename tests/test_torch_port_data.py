"""The port's data path against the JAX package's, on the synthetic
dataset: the generator, the info converter, the radar and LiDAR loaders,
``NewScenesDetDataset`` and the loaders.

* ``devkit/synthetic.py:generate`` writes the same tables, point files and
  camera JPEGs byte for byte; with ``images=False`` the same files less
  the JPEGs;
* ``create_newscenes_infos`` writes the same infos;
* the radar sweep loader's NumPy path is bit-equal to JAX's
  (``use_native=False``), and its default (the native C++ path) within
  1e-6 of JAX's default;
* dataset samples (radar and LiDAR, train and test mode, with the seeded
  point shuffle and pad-or-drop) and ``TrainLoader`` / ``EvalLoader``
  batches over two epochs are bit-equal, both packages' radar sweeps on
  their NumPy path;
* the camera and occupancy options and the points' training augmentation
  load what JAX's dataset loads; ``TrainLoader(num_workers=2)`` gives the
  inline batches (``tests/test_torch_port_host_feed.py`` holds the pool,
  ``tests/test_torch_port_augmentation.py`` the augmentation).
"""

import filecmp
import functools
import os
import pickle

import numpy as np
import pytest

from omnihd_scenes_tpu.data import native as jax_native
from omnihd_scenes_tpu.data.dataset import (
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.data.loader import (EvalLoader as JaxEvalLoader,
                                           TrainLoader as JaxTrainLoader)
from omnihd_scenes_tpu.data.radar_loading import (
    load_radar_sweep as jax_load_radar_sweep)
from omnihd_scenes_tpu.devkit.converter import (
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, generate as jax_generate)
from omnihd_scenes_tpu_torch.data import radar_loading as port_radar_loading
from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
from omnihd_scenes_tpu_torch.data.loader import EvalLoader, TrainLoader
from omnihd_scenes_tpu_torch.data.radar_loading import load_radar_sweep
from omnihd_scenes_tpu_torch.data.sampling import wrap_dataset
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)

SMALL = dict(n_scenes=2, samples_per_scene=7, n_lidar_points=1024,
             n_radar_points=96, image_hw=(54, 96))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope='module')
def generated(tmp_path_factory):
    roots = {k: str(tmp_path_factory.mktemp(k))
             for k in ('jax', 'port', 'port_noimg')}
    jax_generate(roots['jax'], 'v1.0-mini', JaxSyntheticConfig(**SMALL))
    generate(roots['port'], 'v1.0-mini', SyntheticConfig(**SMALL))
    generate(roots['port_noimg'], 'v1.0-mini', SyntheticConfig(**SMALL),
             images=False)
    return roots


def test_generator_writes_the_same_files(generated):
    files = _files(generated['jax'])
    assert files == _files(generated['port'])
    assert sum(f.endswith('.jpg') for f in files) == 2 * 7 * 6
    _, mismatch, errors = filecmp.cmpfiles(generated['jax'],
                                           generated['port'], files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_generator_without_images(generated):
    files = [f for f in _files(generated['jax']) if not f.endswith('.jpg')]
    assert files == _files(generated['port_noimg'])
    _, mismatch, errors = filecmp.cmpfiles(generated['jax'],
                                           generated['port_noimg'], files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _assert_tree_equal(a, b, path=''):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


@pytest.fixture(scope='module')
def infos(generated, tmp_path_factory):
    """Both converters' infos of the JAX-generated dataroot, 2 LiDAR
    sweeps."""
    root = generated['jax']
    out = {k: str(tmp_path_factory.mktemp(f'infos_{k}'))
           for k in ('jax', 'port')}
    jax_create_infos(root, out['jax'], 'synth', version='v1.0-mini',
                     max_sweeps=2)
    create_newscenes_infos(root, out['port'], 'synth', version='v1.0-mini',
                           max_sweeps=2)
    return out


@pytest.mark.parametrize('split', ['train', 'val'])
def test_converter_writes_the_same_infos(infos, split):
    name = f'synth_infos_temporal_{split}.pkl'
    with open(os.path.join(infos['jax'], name), 'rb') as f:
        want = pickle.load(f)
    with open(os.path.join(infos['port'], name), 'rb') as f:
        got = pickle.load(f)
    assert len(want['infos']) > 0
    _assert_tree_equal(got, want)


@pytest.fixture()
def jax_numpy_radar(monkeypatch):
    """Both packages' radar sweeps on their NumPy path (``use_native=
    False``); ``tests/test_torch_port_host_feed.py`` holds the native
    paths to each other."""
    monkeypatch.setattr(jax_native, 'radar_sweep_native',
                        lambda *a, **k: None)
    monkeypatch.setattr(port_radar_loading, 'load_radar_sweep',
                        functools.partial(port_radar_loading.load_radar_sweep,
                                          use_native=False))


def _sweeps(infos):
    with open(os.path.join(infos['jax'], 'synth_infos_temporal_train.pkl'),
              'rb') as f:
        info = pickle.load(f)['infos'][3]
    return [(key, s) for key, sweeps in info['radars'].items()
            for s in sweeps]


def test_radar_sweep_bit_equal_to_the_numpy_path(infos):
    for key, sweep in _sweeps(infos):
        want = jax_load_radar_sweep(sweep, key, use_native=False)
        got = load_radar_sweep(sweep, key, use_native=False)
        assert got.dtype == want.dtype and len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_radar_sweep_near_the_native_path(infos):
    for key, sweep in _sweeps(infos):
        want = jax_load_radar_sweep(sweep, key)
        got = load_radar_sweep(sweep, key)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(want).max())))


DATASETS = {
    'radar-train': dict(modality='radar', max_points=300, max_gt=16,
                        point_shuffle=True, radar_sweeps=3),
    'radar-test': dict(modality='radar', max_points=300, max_gt=16,
                       test_mode=True, radar_sweeps=3),
    'radar-dims': dict(modality='radar', max_points=200,
                       radar_use_dim=(0, 1, 2, 5, 6), point_shuffle=True),
    'lidar-train': dict(modality='lidar', max_points=1500, max_gt=16,
                        lidar_load_dim=5, lidar_use_dim=4,
                        point_shuffle=True),
    'lidar-sweeps': dict(modality='lidar', max_points=3000, lidar_sweeps=2,
                         point_shuffle=True, pc_range=(-30, -20, -3, 30, 20,
                                                       5)),
    'lidar-test': dict(modality='lidar', max_points=1500, test_mode=True),
}


def _datasets(infos, kind, seed=0):
    ann = 'synth_infos_temporal_train.pkl'
    kw = dict(DATASETS[kind], seed=seed)
    return (JaxDataset(ann_file=os.path.join(infos['jax'], ann), **kw),
            NewScenesDetDataset(ann_file=os.path.join(infos['port'], ann),
                                **kw))


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('kind', list(DATASETS))
def test_dataset_samples_bit_equal(infos, kind, jax_numpy_radar):
    """Every sample twice over (the seeded RandomState moves on)."""
    want_ds, got_ds = _datasets(infos, kind)
    assert got_ds.point_dim == want_ds.point_dim
    for _ in range(2):
        for i in range(len(want_ds)):
            want, got = want_ds[i], got_ds[i]
            _assert_batches_equal(got, want)
    assert got['points'].shape[-1] == want_ds.point_dim


@pytest.mark.parametrize('kind', ['radar-train', 'lidar-train'])
def test_train_loader_batches_over_two_epochs(infos, kind, jax_numpy_radar):
    want_ds, got_ds = _datasets(infos, kind, seed=3)
    want_l, got_l = JaxTrainLoader(want_ds, 3, seed=5), TrainLoader(
        got_ds, 3, seed=5)
    assert len(got_l) == len(want_l) == 3       # 7 samples, padded
    for epoch in range(2):
        want_l.set_epoch(epoch)
        got_l.set_epoch(epoch)
        batches = list(zip(got_l, want_l, strict=True))
        for got, want in batches:
            _assert_batches_equal(got, want)
    assert not np.array_equal(batches[0][0]['index'],
                              np.arange(3, dtype=np.int32))


@pytest.mark.parametrize('kind', ['radar-test', 'lidar-test'])
def test_eval_loader_batches(infos, kind, jax_numpy_radar):
    want_ds, got_ds = _datasets(infos, kind)
    pairs = list(zip(EvalLoader(got_ds, 3), JaxEvalLoader(want_ds, 3),
                     strict=True))
    assert len(pairs) == 3
    for (got, got_valid), (want, want_valid) in pairs:
        _assert_batches_equal(got, want)
        np.testing.assert_array_equal(got_valid, want_valid)
    assert not pairs[-1][0][1].all()             # the padded last batch


def test_repeat_wrapper_matches(infos, jax_numpy_radar):
    from omnihd_scenes_tpu.data.sampling import wrap_dataset as jax_wrap

    want_ds, got_ds = _datasets(infos, 'radar-train')
    want = jax_wrap(want_ds, {'type': 'RepeatDataset', 'times': 2})
    got = wrap_dataset(got_ds, {'type': 'RepeatDataset', 'times': 2})
    assert len(got) == len(want) == 14
    for i in (0, 9, 13):
        _assert_batches_equal(got[i], want[i])


@pytest.mark.parametrize('option', [
    {'modality': 'camera'}, {'use_camera': True}, {'load_depth_gt': True},
    {'load_occ': True}, {'aug': {'rot_scale_flip': {}}}])
def test_camera_options_load_and_aug_is_refused(infos, option,
                                                jax_numpy_radar):
    """The camera and occupancy options and training augmentation, each
    refused until its part was ported, now give samples bit-equal to
    JAX's (``load_depth_gt`` alone, without the cameras, reads nothing,
    as in JAX; ``tests/test_torch_port_camera_data.py`` holds the depth
    targets; the points' ``rot_scale_flip`` draws from the seeded rng)."""
    ann = 'synth_infos_temporal_train.pkl'
    kw = dict(max_points=300, max_gt=16, radar_sweeps=2, **option)
    want_ds = JaxDataset(ann_file=os.path.join(infos['jax'], ann), **kw)
    got_ds = NewScenesDetDataset(ann_file=os.path.join(infos['port'], ann),
                                 **kw)
    for i in (0, 5):
        _assert_batches_equal(got_ds[i], want_ds[i])
    keys = set(got_ds[0])
    assert ('imgs' in keys) == ('use_camera' in option)
    assert ('gt_occ' in keys) == ('load_occ' in option)
    assert ('points' in keys) == (option.get('modality') != 'camera')


def test_worker_pool_is_refused(infos):
    """The worker pool, refused until it was ported, gives the inline
    loader's batches (a dataset that draws nothing from its rng: room for
    every point and no shuffle, since the pool reseeds each worker's)."""
    ds = NewScenesDetDataset(
        ann_file=os.path.join(infos['port'], 'synth_infos_temporal_train.pkl'),
        modality='radar', max_points=4000, max_gt=16, radar_sweeps=3)
    pooled = TrainLoader(ds, 2, seed=4, num_workers=2)
    try:
        got = list(pooled)
    finally:
        pooled.close()
    want = list(TrainLoader(ds, 2, seed=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
