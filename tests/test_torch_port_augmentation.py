"""The port's training augmentation (``data/augmentation.py`` and
``NewScenesDetDataset(aug=...)``) against the JAX package's, on the CPU:

* every function bit-equal to JAX's on an equal ``RandomState``, and the
  two generators in the same state afterwards: ``rgb_to_hsv`` /
  ``hsv_to_rgb``, ``photometric_distortion`` (per-sample and per-view
  draws), ``global_rot_scale_trans`` and ``random_flip_3d`` (with the
  radar velocity dims), ``sample_crop_resize_flip``,
  ``crop_resize_flip_images`` (OpenCV) and ``global_rot_scale_trans_image``
  (with points);
* dataset samples with ``aug`` bit-equal to JAX's over a synthetic
  dataroot with camera JPEGs: the camera pipeline (photometric +
  crop-resize-flip + the image rot-scale-flip, ``img2lidar`` recomputed
  in f64) and the points-only ``rot_scale_flip``;
* one BEVFusion training step of the mini configuration of
  ``tests/test_torch_port_train.py`` on a batch augmented with each flip
  and the rotation range's two ends (every camera's projection a
  reflection): the augmented batch is the
  same in both packages, and the port's f64 loss and every gradient leaf
  hold to JAX's f64 at that file's tolerances (1e-6 and 1e-5 of max|ref|);
  the LSS view transform runs its plain version on the CPU.
"""

import functools
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

import jax  # noqa: E402

from omnihd_scenes_tpu.data import augmentation as JA  # noqa: E402
from omnihd_scenes_tpu.data import native as jax_native  # noqa: E402
from omnihd_scenes_tpu.data.dataset import (  # noqa: E402
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.devkit.converter import (  # noqa: E402
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.synthetic import (  # noqa: E402
    SyntheticConfig as JaxSyntheticConfig, generate as jax_generate)
from omnihd_scenes_tpu.models.bevfusion import (  # noqa: E402
    BEVFusion as JaxBEVFusion)
from omnihd_scenes_tpu.train.builder import (  # noqa: E402
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu_torch.data import augmentation as A  # noqa: E402
from omnihd_scenes_tpu_torch.data import (  # noqa: E402
    radar_loading as port_radar_loading)
from omnihd_scenes_tpu_torch.data.dataset import (  # noqa: E402
    NewScenesDetDataset)
from omnihd_scenes_tpu_torch.data.image_loading import (  # noqa: E402
    IMAGENET_MEAN, IMAGENET_STD)
from tests.test_torch_port_train import (  # noqa: E402
    DEPTH_RANGE, JAX_TRAIN_CFG, _f64, _leaf_errors, _port_step, _torch,
    train_batch, train_variables)

torch.set_num_threads(1)


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want, (got, want)


def _same_state(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def _normalized_imgs(rng, n=2, hw=(12, 20)):
    pix = rng.uniform(0, 255, (n, *hw, 3)).astype(np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return ((pix - mean) / std).astype(np.float32)


def _boxes(rng, g=7):
    b = rng.uniform(-20, 20, (g, 9)).astype(np.float32)
    b[:, 3:6] = rng.uniform(0.5, 4, (g, 3))
    return b


def _l2i(rng, n=2):
    m = rng.randn(n, 4, 4).astype(np.float32)
    m[:, 3] = [0, 0, 0, 1]
    return m


def test_hsv_round_trip_bit_equal():
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, (4, 5, 3)).astype(np.float32)
    img[0, 0] = 0
    img[1, 1] = 37.0                        # grey: c == 0
    want = JA.rgb_to_hsv(img)
    got = A.rgb_to_hsv(img)
    _equal(got, want)
    _equal(A.hsv_to_rgb(*got), JA.hsv_to_rgb(*want))


@pytest.mark.parametrize('per_view', [False, True])
@pytest.mark.parametrize('seed', range(4))
def test_photometric_distortion_bit_equal(per_view, seed):
    imgs = _normalized_imgs(np.random.RandomState(100 + seed), n=3)
    r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
    want = JA.photometric_distortion(imgs, r_jax, per_view=per_view)
    got = A.photometric_distortion(imgs, r_port, per_view=per_view)
    _equal(got, want)
    _same_state(r_port, r_jax)


@pytest.mark.parametrize('seed', range(3))
def test_point_rot_scale_flip_bit_equal(seed):
    rng = np.random.RandomState(seed + 10)
    pts = rng.uniform(-30, 30, (50, 8)).astype(np.float32)
    boxes = _boxes(rng)
    r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
    kw = dict(vel_dims=(3, 5), trans_std=(0.2, 0.2, 0.1))
    want = JA.global_rot_scale_trans(pts, boxes, r_jax, **kw)
    got = A.global_rot_scale_trans(pts, boxes, r_port, **kw)
    _equal(got, want)
    want = JA.random_flip_3d(want[0], want[1], r_jax, vel_dims=(3, 5))
    got = A.random_flip_3d(got[0], got[1], r_port, vel_dims=(3, 5))
    _equal(got, want)
    _same_state(r_port, r_jax)


@pytest.mark.parametrize('seed', range(3))
def test_crop_resize_flip_bit_equal(seed):
    rng = np.random.RandomState(seed + 20)
    imgs = rng.randn(2, 40, 64, 3).astype(np.float32)
    l2i = _l2i(rng)
    conf = {'resize': [24, 32, 36], 'crop': (4, 6, 60, 38),
            'rand_flip': True}
    r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
    want = JA.sample_crop_resize_flip(r_jax, conf)
    got = A.sample_crop_resize_flip(r_port, conf)
    _equal(got, want)
    _same_state(r_port, r_jax)
    for flip in (False, True):
        params = (*want[:3], flip)
        _equal(A.crop_resize_flip_images(imgs, l2i, *params),
               JA.crop_resize_flip_images(imgs, l2i, *params))


@pytest.mark.parametrize('kw', [
    {}, {'flip_dx_ratio': 1.0, 'flip_dy_ratio': 1.0},
    {'rot_range': (22.5, 22.5), 'flip_dx_ratio': 1.0, 'flip_dy_ratio': 0.0},
    {'rot_range': (-22.5, -22.5), 'flip_dx_ratio': 0.0,
     'flip_dy_ratio': 1.0}])
def test_image_rot_scale_flip_bit_equal(kw):
    rng = np.random.RandomState(30)
    pts = rng.uniform(-30, 30, (40, 8)).astype(np.float32)
    boxes, l2i = _boxes(rng), _l2i(rng, 6)
    r_jax, r_port = (np.random.RandomState(3) for _ in range(2))
    want = JA.global_rot_scale_trans_image(boxes, l2i, r_jax, points=pts,
                                           vel_dims=(3, 5), **kw)
    got = A.global_rot_scale_trans_image(boxes, l2i, r_port, points=pts,
                                         vel_dims=(3, 5), **kw)
    _equal(got, want)
    _same_state(r_port, r_jax)


SYNTH = dict(n_scenes=2, samples_per_scene=3, n_lidar_points=512,
             n_radar_points=64, image_hw=(54, 96))
AUGS = {
    'camera': dict(
        use_camera=True, max_points=256, max_gt=16, radar_sweeps=2,
        point_shuffle=True,
        aug={'photometric': True,
             'crop_resize_flip': {'resize': [40, 48], 'crop': (0, 6, 96, 54),
                                  'rand_flip': True},
             'rot_scale_flip_image': {}}),
    'camera, per-view photometric': dict(
        modality='camera', use_camera=True, max_gt=16,
        aug={'photometric': 'per_view', 'rot_scale_flip_image': {
            'flip_dx_ratio': 1.0, 'flip_dy_ratio': 1.0}}),
    'points': dict(max_points=300, max_gt=16, radar_sweeps=3,
                   point_shuffle=True,
                   aug={'rot_scale_flip': {'flip_ratio': 0.7}}),
}


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aug_synth'))
    jax_generate(root, 'v1.0-mini', JaxSyntheticConfig(**SYNTH))
    jax_create_infos(root, root, 'synth', version='v1.0-mini', max_sweeps=1)
    return root


@pytest.fixture()
def numpy_radar(monkeypatch):
    """Both packages' radar sweeps on their NumPy path."""
    monkeypatch.setattr(jax_native, 'radar_sweep_native',
                        lambda *a, **k: None)
    monkeypatch.setattr(port_radar_loading, 'load_radar_sweep',
                        functools.partial(port_radar_loading.load_radar_sweep,
                                          use_native=False))


@pytest.mark.parametrize('kind', list(AUGS))
def test_dataset_with_aug_bit_equal(dataroot, kind, numpy_radar):
    """Every sample twice over (the seeded rng moves on)."""
    ann = os.path.join(dataroot, 'synth_infos_temporal_train.pkl')
    want_ds = JaxDataset(ann_file=ann, seed=5, **AUGS[kind])
    got_ds = NewScenesDetDataset(ann_file=ann, seed=5, **AUGS[kind])
    for _ in range(2):
        for i in range(len(want_ds)):
            _equal(got_ds[i], want_ds[i])
    _same_state(got_ds.rng, want_ds.rng)


# -- one augmented train step ----------------------------------------------

# Per sample: the rotation range's end (degrees), flip_dx, flip_dy.  One
# flip each, so every camera's projection becomes a reflection.
DRAWS = ((22.5, 1.0, 0.0), (-22.5, 0.0, 1.0))


def _augment(mod, batch):
    """Each sample through ``mod``'s photometric jitter and image
    rot-scale-flip with the draws of ``DRAWS``."""
    out = {k: v.copy() for k, v in batch.items()}
    rng = np.random.RandomState(42)
    for s in range(len(batch['imgs'])):
        img2lidar = np.tile(np.eye(4), (6, 1, 1))
        img2lidar[:, :3, :3] = batch['img2lidar_rots'][s]
        img2lidar[:, :3, 3] = batch['img2lidar_trans'][s]
        l2i = np.linalg.inv(img2lidar).astype(np.float32)
        out['imgs'][s] = mod.photometric_distortion(batch['imgs'][s], rng)
        rot, flip_dx, flip_dy = DRAWS[s]
        boxes, l2i, pts, params = mod.global_rot_scale_trans_image(
            batch['gt_boxes'][s], l2i, rng, points=batch['points'][s],
            vel_dims=(3, 5), rot_range=(rot, rot), flip_dx_ratio=flip_dx,
            flip_dy_ratio=flip_dy)
        assert (params['flip_dx'], params['flip_dy']) == (flip_dx == 1,
                                                          flip_dy == 1)
        out['gt_boxes'][s], out['points'][s] = boxes, pts
        inv = np.linalg.inv(l2i.astype(np.float64))
        out['img2lidar_rots'][s] = inv[:, :3, :3]
        out['img2lidar_trans'][s] = inv[:, :3, 3]
    return out


@pytest.fixture(scope='module')
def aug_step():
    batch = train_batch()
    variables = train_variables(batch)
    want_batch = _augment(JA, batch)
    got_batch = _augment(A, batch)
    loss_fn = jax_make_loss_fn(JaxBEVFusion(JAX_TRAIN_CFG), 'bevfusion',
                               JAX_TRAIN_CFG.pillars.anchors(),
                               camera_depth_range=DEPTH_RANGE)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with jax.enable_x64(True):
        (loss, (aux, _)), grads = grad_fn(*_f64(
            (variables['params'], variables['batch_stats'], want_batch)))
        want = (float(loss), {k: float(v) for k, v in aux.items()},
                _torch(grads, 'params'))
    port = _port_step(variables, got_batch, torch.float64)
    return batch, want_batch, got_batch, want, port


def test_augmented_batch_bit_equal(aug_step):
    batch, want_batch, got_batch, _, _ = aug_step
    _equal(got_batch, want_batch)
    # One flip each: every camera's projection is now a reflection.
    rots = got_batch['img2lidar_rots']
    assert (np.linalg.det(rots.astype(np.float64))
            * np.linalg.det(batch['img2lidar_rots'].astype(np.float64))
            < 0).all()
    assert not np.allclose(rots, batch['img2lidar_rots'])


def test_augmented_step_loss_and_gradients(aug_step):
    *_, (j_loss, j_aux, j_grads), (p_loss, p_aux, _, p_grads, _) = aug_step
    assert abs(p_loss - j_loss) <= 1e-6 * abs(j_loss)
    for k, v in j_aux.items():
        assert abs(p_aux[k] - v) <= 1e-6 * abs(v) + 1e-9, k
    assert j_aux['num_pos'] >= 2
    assert set(p_grads) == set(j_grads)
    err = _leaf_errors(p_grads, j_grads, 1e-9)
    bad = {k: v for k, v in err.items() if v > 1e-5}
    assert not bad, bad
    assert float(p_grads['lss.depthnet.depth_conv.weight'].abs().max()) > 0
