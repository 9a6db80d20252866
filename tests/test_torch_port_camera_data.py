"""The port's camera data path and occupancy eval against the JAX
package's, on a JAX-generated synthetic dataroot with distorted camera
JPEGs, LiDAR depth GT (JAX's ``tools/gen_depth_gt.py`` projection) and
occupancy GT (needs OpenCV, as the camera loaders do):

* dataset samples with cameras, depth targets and occupancy GT bit-equal
  to JAX's ``NewScenesDetDataset``: ``imgs``, ``lidar2img``,
  ``img2lidar_rots`` / ``img2lidar_trans``, ``depth_gaussian``,
  ``depth_min``, ``gt_occ`` (with and without ``occ_downsample``,
  ``image_fast_decode`` on and off, radar + camera and camera only);
* ``TrainLoader`` / ``EvalLoader`` batches equal, carrying those keys;
* the restated loaders equal JAX's (``build_lidar2img``,
  ``rasterize_depth``, ``gaussian_depth_target``, the fused rectify map);
* ``evaluate_results`` on the same detection and occupancy predictions
  gives the metric dict of JAX's, with and without ``bad_conditions``;
* without OpenCV the loader says that it needs it.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from omnihd_scenes_tpu.data import depth_loading as jax_depth  # noqa: E402
from omnihd_scenes_tpu.data import image_loading as jax_image  # noqa: E402
from omnihd_scenes_tpu.data import native as jax_native  # noqa: E402
from omnihd_scenes_tpu.data.dataset import (  # noqa: E402
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.data.lidar_loading import (  # noqa: E402
    load_lidar_points as jax_load_lidar_points)
from omnihd_scenes_tpu.data.loader import (  # noqa: E402
    EvalLoader as JaxEvalLoader, TrainLoader as JaxTrainLoader)
from omnihd_scenes_tpu.devkit.converter import (  # noqa: E402
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.synthetic import (  # noqa: E402
    SyntheticConfig as JaxSyntheticConfig, generate as jax_generate)
from omnihd_scenes_tpu.tools.gen_depth_gt import (  # noqa: E402
    depth_points_for_cam)
from omnihd_scenes_tpu.train.eval_runner import (  # noqa: E402
    evaluate_results as jax_evaluate_results)
from omnihd_scenes_tpu_torch.data import depth_loading  # noqa: E402
from omnihd_scenes_tpu_torch.data import image_loading  # noqa: E402
from omnihd_scenes_tpu_torch.data import (  # noqa: E402
    radar_loading as port_radar_loading)
from omnihd_scenes_tpu_torch.data.dataset import (  # noqa: E402
    NewScenesDetDataset)
from omnihd_scenes_tpu_torch.data.loader import (  # noqa: E402
    EvalLoader, TrainLoader)
from omnihd_scenes_tpu_torch.train.eval_runner import (  # noqa: E402
    evaluate_results)
from tests.test_torch_port_eval import padded_detections  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(n_scenes=4, samples_per_scene=3, n_lidar_points=2048,
             n_radar_points=96, image_hw=(108, 192),
             cam_distortion=(-0.3, 0.1, 0.0, 0.0, 0.0))
CAMERA_KEYS = ('imgs', 'lidar2img', 'img2lidar_rots', 'img2lidar_trans',
               'depth_gaussian', 'depth_min', 'gt_occ')


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    """Dataroot, infos and per-camera depth GT ([u, v, d] bins beside
    each JPEG, where ``load_gt_depth`` reads them)."""
    root = str(tmp_path_factory.mktemp('camera_synth'))
    jax_generate(root, 'v1.0-mini', JaxSyntheticConfig(**SYNTH))
    jax_create_infos(root, root, 'synth', version='v1.0-mini',
                     max_sweeps=1)
    for split in ('train', 'val'):
        with open(f'{root}/synth_infos_temporal_{split}.pkl', 'rb') as f:
            infos = pickle.load(f)['infos']
        for info in infos:
            pts = jax_load_lidar_points(info['lidar_path'])[:, :3]
            for cam in info['cams'].values():
                l2i, _, _ = jax_image.build_lidar2img(cam)
                depth_points_for_cam(pts, l2i, SYNTH['image_hw']).tofile(
                    cam['data_path'].replace('cameras', 'depth_gt') + '.bin')
    return root


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


CAMERA = dict(use_camera=True, load_depth_gt=True, load_occ=True,
              max_points=256, max_gt=16, radar_sweeps=2, point_shuffle=True)
DATASETS = {
    'radar + camera, train': dict(CAMERA),
    'fast decode': dict(CAMERA, image_fast_decode=True),
    'occ downsample 8x8x1': dict(CAMERA, occ_downsample=(8, 8, 1)),
    'fast decode, occ downsample, test mode': dict(
        CAMERA, image_fast_decode=True, occ_downsample=(8, 8, 2),
        test_mode=True),
    'camera only, scale 1, padded': dict(
        modality='camera', use_camera=True, load_depth_gt=True,
        image_scale=1.0, front_back_scale=1.0, image_target_hw=(128, 192),
        max_gt=16),
}


def _datasets(root, kind, split='train'):
    ann = os.path.join(root, f'synth_infos_temporal_{split}.pkl')
    kw = DATASETS[kind]
    return JaxDataset(ann_file=ann, **kw), NewScenesDetDataset(ann_file=ann,
                                                               **kw)


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('kind', list(DATASETS))
def test_dataset_samples_bit_equal(dataroot, kind, jax_numpy_radar):
    want_ds, got_ds = _datasets(dataroot, kind)
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        _assert_batches_equal(got, want)
    keys = set(got)
    assert {'imgs', 'lidar2img', 'img2lidar_rots', 'img2lidar_trans',
            'depth_gaussian', 'depth_min'} <= keys
    assert ('gt_occ' in keys) == DATASETS[kind].get('load_occ', False)
    assert float(got['depth_min'].max()) > 0           # depth observed
    if 'gt_occ' in keys:
        assert int((got['gt_occ'] > 0).sum()) > 0


def test_occupancy_grid_shapes(dataroot):
    sizes = {}
    for kind in ('radar + camera, train', 'occ downsample 8x8x1'):
        _, ds = _datasets(dataroot, kind)
        sizes[kind] = ds[0]['gt_occ'].shape
    assert sizes == {'radar + camera, train': (240, 160, 16),
                     'occ downsample 8x8x1': (30, 20, 16)}


@pytest.mark.parametrize('kind', ['radar + camera, train', 'fast decode'])
def test_loader_batches(dataroot, kind, jax_numpy_radar):
    want_ds, got_ds = _datasets(dataroot, kind)
    for epoch in range(2):
        want_l = JaxTrainLoader(want_ds, 2, seed=3)
        got_l = TrainLoader(got_ds, 2, seed=3)
        want_l.set_epoch(epoch)
        got_l.set_epoch(epoch)
        for got, want in zip(got_l, want_l):
            _assert_batches_equal(got, want)
            assert set(CAMERA_KEYS) <= set(got)
            assert got['imgs'].shape[:2] == (2, 6)
    for (got, gv), (want, wv) in zip(EvalLoader(got_ds, 4),
                                     JaxEvalLoader(want_ds, 4)):
        _assert_batches_equal(got, want)
        np.testing.assert_array_equal(gv, wv)


def test_restated_loaders_equal_jax(dataroot):
    with open(f'{dataroot}/synth_infos_temporal_train.pkl', 'rb') as f:
        info = pickle.load(f)['infos'][1]
    for cam in info['cams'].values():
        for got, want in zip(image_loading.build_lidar2img(cam),
                             jax_image.build_lidar2img(cam)):
            np.testing.assert_array_equal(got, want)
    cam = info['cams']['camera_front']
    _, _, viewpad = jax_image.build_lidar2img(cam)
    for got, want in zip(
            image_loading._fused_rectify_map(
                viewpad, cam['cam_distortion'], (108, 192), 0.25, 4,
                ('port',)),
            jax_image._fused_rectify_map(
                viewpad, cam['cam_distortion'], (108, 192), 0.25, 4,
                ('jax',))):
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(0)
    uvd = np.stack([rng.uniform(-5, 200, 300), rng.uniform(-5, 120, 300),
                    rng.uniform(0.5, 70, 300)], 1).astype(np.float32)
    dmap = depth_loading.rasterize_depth(uvd, (64, 96), 0.5)
    np.testing.assert_array_equal(
        dmap, jax_depth.rasterize_depth(uvd, (64, 96), 0.5))
    for std in (None, 2.0):
        for got, want in zip(
                depth_loading.gaussian_depth_target(dmap, 4, (1, 60, 1), std),
                jax_depth.gaussian_depth_target(dmap, 4, (1, 60, 1), std)):
            np.testing.assert_array_equal(got, want)


def _occ_predictions(ds, seed=4):
    """Per-sample argmax-like grids: the GT with a third of the voxels
    relabelled at random."""
    rng = np.random.RandomState(seed)
    out = []
    for info in ds.infos:
        gt = ds._load_occ(info)
        pred = np.where(rng.uniform(size=gt.shape) < 0.33,
                        rng.randint(0, 12, gt.shape), gt)
        out.append(pred.astype(np.int64))
    return out


@pytest.mark.parametrize('bad_conditions', [False, True])
def test_evaluate_results_equal_jax(dataroot, tmp_path, bad_conditions):
    """Detection + occupancy metrics of the same predictions on the train
    split (a sunny-day scene and a night scene, which ``bad_conditions``
    alone keeps), keys ``occ_IoU``, ``occ_cls_<i>``, ``occ_mIoU``."""
    kw = dict(use_camera=False, load_occ=True, occ_downsample=(8, 8, 1),
              max_points=64, test_mode=True)
    ann = os.path.join(dataroot, 'synth_infos_temporal_train.pkl')
    want_ds, got_ds = JaxDataset(ann_file=ann, **kw), NewScenesDetDataset(
        ann_file=ann, **kw)
    outputs = {'bbox_results': padded_detections(len(got_ds)),
               'occ_results': _occ_predictions(got_ds)}
    args = dict(dataroot=dataroot, version='v1.0-mini', eval_set='train_mini',
                bad_conditions=bad_conditions)
    want = jax_evaluate_results(want_ds, outputs,
                                jsonfile_prefix=str(tmp_path / 'jax'), **args)
    got = evaluate_results(got_ds, outputs,
                           jsonfile_prefix=str(tmp_path / 'port'), **args)
    assert list(got) == list(want)
    for k, v in want.items():
        assert (v != v and got[k] != got[k]) or got[k] == v, k
    assert {'occ_IoU', 'occ_mIoU', 'occ_cls_1', 'occ_cls_11'} <= set(got)
    assert np.isfinite(got['occ_IoU']) and np.isfinite(got['occ_mIoU'])


def test_bad_conditions_keep_only_the_night_scene(dataroot, tmp_path):
    kw = dict(use_camera=False, load_occ=True, occ_downsample=(8, 8, 1),
              max_points=64, test_mode=True)
    ds = NewScenesDetDataset(ann_file=os.path.join(
        dataroot, 'synth_infos_temporal_train.pkl'), **kw)
    outputs = {'bbox_results': padded_detections(len(ds)),
               'occ_results': _occ_predictions(ds)}
    metrics = [evaluate_results(ds, outputs, dataroot, 'v1.0-mini',
                                'train_mini', str(tmp_path / str(b)),
                                bad_conditions=b) for b in (False, True)]
    assert metrics[0]['occ_IoU'] != metrics[1]['occ_IoU']
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        bad_condition_scenes)
    bad = bad_condition_scenes(ds, dataroot, 'v1.0-mini')
    assert 0 < len(bad) < len({i['scene_token'] for i in ds.infos})


def test_loader_needs_opencv(dataroot):
    """With OpenCV blocked, loading a camera sample raises an ImportError
    that names the camera data path and OpenCV."""
    code = ('import sys; sys.modules["cv2"] = None\n'
            'from omnihd_scenes_tpu_torch.data.dataset import '
            'NewScenesDetDataset\n'
            f'ds = NewScenesDetDataset(ann_file={dataroot!r} + '
            '"/synth_infos_temporal_train.pkl", use_camera=True, '
            'max_points=8)\n'
            'try:\n'
            '    ds[0]\n'
            'except ImportError as e:\n'
            '    print("ImportError:", e)\n')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'camera data path' in proc.stdout and 'OpenCV' in proc.stdout
