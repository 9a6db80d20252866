"""Camera training from a JPEG dataroot through the device decode, run on
the CPU through the kernels' plain versions, against the JAX package's
host datasets (OpenCV) on a JAX-generated synthetic dataroot with
distorted 108x192 JPEGs and the port's ``tools.gen_depth_gt`` depth GT:

* a device-mode training sample (``image_decode='device'``) with depth
  targets and all three image augmentations has every key but the pixels
  bit-equal to the JAX dataset's sample for the same seed (photometric
  per sample and per view; the canvas left to the divisor or set), and
  carries the draws as records;
* ``decode_camera_batch`` of the collated samples (host entropy decode,
  the plain IDCT, ``rectify``, ``photometric``, ``crop_resize_flip``)
  gives JAX's host ``imgs`` within 1e-5 of max|ref| (the f32 resizes'
  bound, ``test_torch_port_camera_decode.py``), bit for bit where no f32
  resize is involved;
* the plain versions of the two new kernels against JAX's
  ``photometric_distortion`` and ``crop_resize_flip_images`` on the same
  draws;
* the temporal training queue in device mode decoded to (B, T, N, H, W,
  3) against JAX's stacked frames;
* one ``run_training`` epoch on the CPU from a device-mode loader, inline
  and with one worker: the prefetch decodes, the losses are finite.
"""

import functools
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from omnihd_scenes_tpu.data import augmentation as JA  # noqa: E402
from omnihd_scenes_tpu.data import image_loading as jax_image  # noqa: E402
from omnihd_scenes_tpu.data import native as jax_native  # noqa: E402
from omnihd_scenes_tpu.data.dataset import (  # noqa: E402
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.data.temporal_dataset import (  # noqa: E402
    TemporalNewScenesDataset as JaxTemporal)
from omnihd_scenes_tpu.devkit.converter import (  # noqa: E402
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.synthetic import (  # noqa: E402
    SyntheticConfig as JaxSyntheticConfig, generate as jax_generate)
from omnihd_scenes_tpu_torch.data import augmentation as A  # noqa: E402
from omnihd_scenes_tpu_torch.data import image_loading as IL  # noqa: E402
from omnihd_scenes_tpu_torch.data import (  # noqa: E402
    radar_loading as port_radar_loading)
from omnihd_scenes_tpu_torch.data.dataset import (  # noqa: E402
    NewScenesDetDataset)
from omnihd_scenes_tpu_torch.data.loader import (  # noqa: E402
    TrainLoader, collate)
from omnihd_scenes_tpu_torch.data.temporal_dataset import (  # noqa: E402
    TemporalNewScenesDataset)
from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (  # noqa: E402
    crop_resize_flip_plain)
from omnihd_scenes_tpu_torch.kernels.photometric import (  # noqa: E402
    photometric_plain)
from omnihd_scenes_tpu_torch.tools import gen_depth_gt  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(n_scenes=2, samples_per_scene=3, n_lidar_points=2048,
             n_radar_points=64, image_hw=(108, 192),
             cam_distortion=(-0.05, 0.01, 1e-3, -1e-3, 0.0))
CROP = {'resize': [40, 48], 'crop': (8, 4, 88, 52), 'rand_flip': True}
AUG = {'photometric': True, 'crop_resize_flip': CROP,
       'rot_scale_flip_image': {}}
CAMERA = dict(use_camera=True, load_depth_gt=True, max_points=128,
              max_gt=16, radar_sweeps=2, point_shuffle=True)
DATASETS = {
    'radar + camera, per-sample photometric': dict(CAMERA, aug=AUG),
    'radar + camera, per-view photometric': dict(
        CAMERA, aug=dict(AUG, photometric='per_view')),
    'camera only, scale 1, target, photometric only': dict(
        modality='camera', use_camera=True, load_depth_gt=True,
        image_scale=1.0, front_back_scale=1.0, image_target_hw=(128, 192),
        max_gt=16, aug={'photometric': 'per_view',
                        'rot_scale_flip_image': {}}),
}
# Decoded pixels equal bit for bit where the chain has no f32 resize.
EXACT = ('camera only, scale 1, target, photometric only',)


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('camtrain'))
    # The JAX loader keeps undistortion maps by scene token, camera and
    # size, which every synthetic dataroot shares: drop the maps of a
    # dataroot with another calibration that an earlier test module of
    # this process read (tests/test_torch_port_camera_data.py's).
    jax_image._REMAP_CACHE.clear()
    jax_generate(root, 'v1.0-mini', JaxSyntheticConfig(**SYNTH))
    jax_create_infos(root, root, 'synth', version='v1.0-mini', max_sweeps=1)
    for split in ('train', 'val'):
        gen_depth_gt.main([f'{root}/synth_infos_temporal_{split}.pkl',
                           '--img-h', '108', '--img-w', '192'])
    return root


def jax_native_off(monkeypatch):
    """Both packages' radar sweeps on their NumPy path."""
    monkeypatch.setattr(jax_native, 'radar_sweep_native',
                        lambda *a, **k: None)
    monkeypatch.setattr(port_radar_loading, 'load_radar_sweep',
                        functools.partial(port_radar_loading.load_radar_sweep,
                                          use_native=False))


@pytest.fixture()
def numpy_radar(monkeypatch):
    jax_native_off(monkeypatch)


@pytest.fixture()
def no_imdecode(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError('OpenCV on the device-decode path')

    for name in ('imdecode', 'imread', 'resize', 'remap'):
        monkeypatch.setattr(cv2, name, forbidden)


def _ann(root, split='train'):
    return os.path.join(root, f'synth_infos_temporal_{split}.pkl')


def _pixels_close(got, want, exact):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize('kind', list(DATASETS))
def test_device_samples_and_decode_match_jax(dataroot, kind, numpy_radar):
    """Each sample twice over (the rng moves on): non-pixel keys bit-equal,
    the decoded and augmented images JAX's."""
    kw = DATASETS[kind]
    want_ds = JaxDataset(ann_file=_ann(dataroot), seed=3, **kw)
    got_ds = NewScenesDetDataset(ann_file=_ann(dataroot), seed=3,
                                 image_decode='device', **kw)
    aug = kw['aug']
    for _ in range(2):
        for i in range(len(want_ds)):
            want, got = want_ds[i], got_ds[i]
            records = {k for k in IL.CAMERA_RECORD_KEYS if k in got}
            assert set(got) - set(IL.HOST_KEYS) == set(want) - {'imgs'}
            assert (IL.AUG_PHOTOMETRIC in records) == bool(
                aug.get('photometric'))
            assert (IL.AUG_CROP_RESIZE_FLIP in records) == bool(
                aug.get('crop_resize_flip'))
            for k in want:
                if k != 'imgs':
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert float(got['depth_min'].max()) > 0
            out = IL.decode_camera_batch(collate([got]), 'cpu')
            assert not set(IL.HOST_KEYS) & set(out)
            _pixels_close(out['imgs'][0], want['imgs'], kind in EXACT)
    assert got_ds.rng.randint(1 << 30) == want_ds.rng.randint(1 << 30)


def test_collated_batch_decodes_to_jax_images(dataroot, numpy_radar,
                                              no_imdecode, monkeypatch):
    """A b3 batch of one crop height, decoded in one call: each sample's
    images JAX's; with cv2's decode, resize and remap forbidden."""
    kw = dict(CAMERA, aug=dict(AUG, crop_resize_flip=dict(CROP,
                                                          resize=[48])))
    got_ds = NewScenesDetDataset(ann_file=_ann(dataroot), seed=1,
                                 image_decode='device', **kw)
    samples = [got_ds[i] for i in range(len(got_ds))]
    batch = IL.decode_camera_batch(collate(samples), 'cpu')
    assert tuple(batch['imgs'].shape) == (3, 6, 48, 80, 3)
    monkeypatch.undo()              # the JAX reference needs OpenCV back
    jax_native_off(monkeypatch)
    want_ds = JaxDataset(ann_file=_ann(dataroot), seed=1, **kw)
    for i in range(3):
        _pixels_close(batch['imgs'][i], want_ds[i]['imgs'], False)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_plain_kernels_equal_jax_augmentations(seed):
    rng = np.random.RandomState(100 + seed)
    imgs = (rng.randn(6, 24, 40, 3) * 1.7).astype(np.float32)
    imgs[:, :4] = 0.0                               # a zero-pad band
    imgs[:, 4:6, :, 1] = imgs[:, 4:6, :, 0]        # ties of r and g
    imgs[:, 6:8, :, 2] = imgs[:, 6:8, :, 1]        # ties of g and b
    for per_view in (False, True):
        r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
        want = JA.photometric_distortion(imgs, r_jax, per_view=per_view)
        rows = A.draw_photometric(r_port, 6, per_view=per_view)
        got = photometric_plain(torch.from_numpy(imgs), rows).numpy()
        np.testing.assert_array_equal(got, want)
        assert r_port.randint(1 << 30) == r_jax.randint(1 << 30)
    l2i = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    conf = {'resize': [16, 30, 24], 'crop': (4, 2, 50, 22),
            'rand_flip': True}
    params = JA.sample_crop_resize_flip(np.random.RandomState(seed), conf)
    want, _ = JA.crop_resize_flip_images(imgs, l2i, *params)
    rec = np.repeat(A.crop_resize_flip_record(*params)[None], 6, 0)
    got = crop_resize_flip_plain(torch.from_numpy(imgs), rec).numpy()
    _pixels_close(got, want, False)


@pytest.mark.parametrize('scale', [1.0, 0.5])
def test_temporal_queue_decodes_to_jax_frames(dataroot, scale):
    kw = dict(queue_length=3, image_scale=scale, front_back_scale=scale,
              max_gt=16, seed=2)
    want_ds = JaxTemporal(ann_file=_ann(dataroot), **kw)
    got_ds = TemporalNewScenesDataset(ann_file=_ann(dataroot),
                                      image_decode='device', **kw)
    wants = [want_ds[i] for i in range(len(want_ds))]
    gots = [got_ds[i] for i in range(len(got_ds))]
    for got, want in zip(gots, wants):
        assert got[IL.JPEG_OFFSETS].shape == (3, 7)
        for k in want:
            if k != 'imgs':
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    batch = IL.decode_camera_batch(collate(gots), 'cpu')
    imgs = batch['imgs']
    assert tuple(imgs.shape[:3]) == (len(gots), 3, 6)
    for i, want in enumerate(wants):
        _pixels_close(imgs[i], want['imgs'], scale == 1.0)


def test_source_canvas_is_the_host_canvas(dataroot):
    """The padded size the dataset takes from the JPEG headers (no
    decode) is the decode's, with and without a target."""
    info = JaxDataset(ann_file=_ann(dataroot)).infos[0]
    for kw in (dict(), dict(target_hw=(64, 128)), dict(scale=1.0,
                                                      front_back_scale=0.5)):
        src = IL.camera_sources(info, **kw)
        imgs = IL.decode_camera_batch(collate([src]), 'cpu')['imgs']
        assert IL.source_canvas_hw(src) == tuple(imgs.shape[2:4])


def _train(cfg, dataset, num_workers):
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg,
                                                       init_model,
                                                       make_loss_fn_generic)
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step,
                                                    run_training)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(1e-3, 10, warmup_iters=1)))
    step = make_train_step(make_loss_fn_generic(model, mtype,
                                                anchors_for(model, mtype)))
    seen = []

    def spy(state, batch):
        seen.append({k: tuple(v.shape) for k, v in batch.items()
                     if torch.is_tensor(v)})
        assert not set(IL.HOST_KEYS) & set(batch)
        return step(state, batch)

    loader = TrainLoader(dataset, 2, num_workers=num_workers)
    try:
        state = run_training(state, spy, loader, 1, log_interval=1)
    finally:
        loader.close()
    return state, seen


@pytest.mark.parametrize('num_workers', [0, 1])
def test_run_training_from_device_batches(dataroot, num_workers):
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_datasets

    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/synthetic/bevfusion_synth.py'))
    cfg.merge_from_options([
        f'dataroot={dataroot}', f'data.train.ann_file={_ann(dataroot)}',
        f'data.val.ann_file={_ann(dataroot, "val")}'])
    cfg.data.train.aug = dict(AUG, crop_resize_flip=dict(
        CROP, resize=[128], crop=(0, 0, 192, 128)))
    train_ds, val_ds = build_datasets(cfg, image_decode='device')
    assert train_ds.image_decode == val_ds.image_decode == 'device'
    state, seen = _train(cfg, train_ds, num_workers)
    assert int(state.step) == len(seen) == 2
    assert seen[0]['imgs'] == (2, 6, 128, 192, 3)
