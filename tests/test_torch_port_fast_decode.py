"""The device path's ``image_fast_decode`` on the CPU (the kernels' plain
versions) against OpenCV and the JAX package's fast decode
(``omnihd_scenes_tpu/data/image_loading.py:_load_cam_fast``):

* the reduced decode (``data/jpeg.py:decode_jpegs(..., factors=)``: the
  host entropy decode, ``jidctred.c``'s 4x4 / 2x2 / 1x1 IDCTs beside
  islow in one ``jpeg_idct`` call, then the upsampling libjpeg leaves and
  the colour tables) equals ``cv2.imread(..., IMREAD_REDUCED_COLOR_k)``
  bit for bit, k = 2, 4, 8, on 4:4:4, 4:2:2 and 4:2:0 JPEGs of sizes
  that are not multiples of 16, noise and saturated noise (the range
  limit clamps), in one batch with full-size decodes; the scaled sizes
  and chroma modes are libjpeg-turbo's;
* the fused map (``data/undistort.py:fused_rectify_map``) against
  ``cv2.initUndistortRectifyMap(K, D, None, S_net K, out, CV_32FC1)``,
  ``/ factor``, ``cv2.convertMaps(..., CV_16SC2)``: equal on at least
  99.99 % of the entries, the rest within one 1/32-px step (the bound of
  ``test_torch_port_camera_decode.py::test_undistort_map_matches_cv2``);
* ``decode_camera_batch(..., 'cpu')`` of a device-mode dataset with
  ``image_fast_decode=True`` against JAX's ``load_camera_data(...,
  fast_decode=True)`` on a plain and a distorted dataroot of 75 x 131
  JPEGs (1/2 decodes 38 rows, which JAX counts as a 76-row source), with
  a divisor and with a target: ``lidar2img`` and ``img2lidar_*``
  bit-equal, ``imgs`` within 1e-5 (equal here), with ``cv2.imread`` and
  ``cv2.imdecode`` patched to raise while the port decodes;
* one augmented training batch (photometric and crop-resize-flip, depth
  targets at the fast canvas) against the JAX dataset's samples: every
  key but the pixels bit-equal, the pixels within 1e-5 of max|ref|.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from omnihd_scenes_tpu.data import image_loading as jax_image  # noqa: E402
from omnihd_scenes_tpu.data.dataset import (  # noqa: E402
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.devkit.converter import (  # noqa: E402
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.synthetic import (  # noqa: E402
    SyntheticConfig as JaxSyntheticConfig, generate as jax_generate)
from omnihd_scenes_tpu_torch.data import image_loading as IL  # noqa: E402
from omnihd_scenes_tpu_torch.data import jpeg as J  # noqa: E402
from omnihd_scenes_tpu_torch.data.dataset import (  # noqa: E402
    NewScenesDetDataset)
from omnihd_scenes_tpu_torch.data.loader import (  # noqa: E402
    EvalLoader, collate)
from omnihd_scenes_tpu_torch.data.undistort import (  # noqa: E402
    fused_rectify_map, to_cv16sc2)
from omnihd_scenes_tpu_torch.kernels import rectify as R  # noqa: E402
from omnihd_scenes_tpu_torch.tools import gen_depth_gt  # noqa: E402

torch.set_num_threads(1)

DIST = (-0.05, 0.01, 1e-3, -1e-3, 0.0)
HW = (75, 131)
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}


def _jpegs(tmp_path):
    """(path, bytes) of noise JPEGs, each sampling at quality 95 and
    saturated noise at 100."""
    rng = np.random.RandomState(0)
    out = []
    for hw in ((67, 101), (75, 137)):
        for name, flag in SAMPLING.items():
            for quality, saturated in ((95, False), (100, True)):
                img = (rng.randint(0, 2, hw + (3,)) * 255 if saturated
                       else rng.randint(0, 256, hw + (3,))).astype(np.uint8)
                path = str(tmp_path / f'{hw[0]}_{name}_{quality}.jpg')
                assert cv2.imwrite(path, img, [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
                out.append((path, np.fromfile(path, np.uint8)))
    return out


def test_reduced_decode_equals_cv2_imread(tmp_path):
    files = _jpegs(tmp_path)
    factors = [k for k in (2, 4, 8, 1) for _ in files]
    got = J.decode_jpegs([b for _ in range(4) for _, b in files], 'cpu',
                         factors=factors)
    for i, img in enumerate(got):
        path, _ = files[i % len(files)]
        k = factors[i]
        want = cv2.imread(path, REDUCED[k] if k > 1 else cv2.IMREAD_COLOR)
        assert img.dtype == torch.uint8
        np.testing.assert_array_equal(img.numpy(), want,
                                      err_msg=f'{path} 1/{k}')


def test_scaled_sizes_are_libjpeg_turbos():
    """jdmaster.c's DCT scaled sizes and the upsampling jdsample.c picks:
    4:2:0 chroma upsampled by the IDCT; 4:2:2 keeps its fancy h2v1 but at
    1/8, where it is a box filter."""
    def header(sampling, hw=(1080, 1920)):
        return J.JpegHeader(hw[0], hw[1], 3, 0xC0, sampling)

    s420, s422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
    s444 = ((1, 1),) * 3
    assert J.scaled_sizes(header(s420), 1) == ([8, 8, 8], R.CHROMA_420)
    assert J.scaled_sizes(header(s420), 2) == ([4, 8, 8], R.CHROMA_444)
    assert J.scaled_sizes(header(s420), 4) == ([2, 4, 4], R.CHROMA_444)
    assert J.scaled_sizes(header(s420), 8) == ([1, 2, 2], R.CHROMA_444)
    assert J.scaled_sizes(header(s422), 2) == ([4, 4, 4], R.CHROMA_422)
    assert J.scaled_sizes(header(s422), 8) == ([1, 1, 1], R.CHROMA_422_BOX)
    assert J.scaled_sizes(header(s422, (16, 12)), 4)[1] == R.CHROMA_422_BOX
    assert J.scaled_sizes(header(s444), 4) == ([2, 2, 2], R.CHROMA_444)
    with pytest.raises(ValueError, match='factor'):
        J.scaled_sizes(header(s444), 3)
    assert [J.decode_factor(n) for n in (1.0, 0.5, 0.375, 0.25, 0.2,
                                          0.125)] == [1, 2, 2, 4, 4, 8]


@pytest.mark.parametrize('hw,net,factor,dist', [
    ((1080, 1920), 0.5, 2, DIST), ((1080, 1920), 0.25, 4, DIST),
    ((1082, 1920), 0.375, 2, (-0.05, 0.01, 1e-3, -1e-3, 0.002)),
    ((76, 132), 0.125, 8, (-0.3, 0.1, 0.0, 0.0, 0.0))])
def test_fused_map_matches_cv2(hw, net, factor, dist):
    h, w = hw
    k = np.array([[w * 0.8, 0.0, w / 2.0], [0.0, w * 0.8, h / 2.0],
                  [0.0, 0.0, 1.0]])
    d = np.asarray(dist)
    fixed = fused_rectify_map(k, d, hw, net, factor)
    out = (int(h * net), int(w * net))
    assert fixed.shape == out + (2,) and fixed.dtype == np.int32
    k_new = k.copy()
    k_new[:2] *= net
    m1, m2 = cv2.initUndistortRectifyMap(k, d, None, k_new, out[::-1],
                                         cv2.CV_32FC1)
    cxy, cfrac = cv2.convertMaps(m1 / factor, m2 / factor, cv2.CV_16SC2)
    xy, frac = to_cv16sc2(fixed)
    assert ((xy == cxy).all(-1) & (frac == cfrac)).mean() >= 0.9999
    cxy, cfrac = cxy.astype(np.int64), cfrac.astype(np.int64)
    ref = np.stack([cxy[..., 0] * 32 + (cfrac & 31),
                    cxy[..., 1] * 32 + (cfrac >> 5)], -1)
    assert np.abs(fixed - ref).max() <= 1
    assert fused_rectify_map(k, np.zeros(5), hw, net, factor) is None


@pytest.fixture(scope='module')
def dataroots(tmp_path_factory):
    """A plain and a distorted dataroot of the JAX generator's 75 x 131
    JPEGs with the port's depth GT."""
    roots = {}
    for name, dist in (('plain', (0.0,) * 5), ('distorted', DIST)):
        root = str(tmp_path_factory.mktemp(f'fast_{name}'))
        jax_generate(root, 'v1.0-mini', JaxSyntheticConfig(
            n_scenes=1, samples_per_scene=2, image_hw=HW,
            n_lidar_points=2048, n_radar_points=32, cam_distortion=dist))
        jax_create_infos(root, root, 'synth', version='v1.0-mini',
                         max_sweeps=0)
        for split in ('train', 'val'):
            gen_depth_gt.main([f'{root}/synth_infos_temporal_{split}.pkl',
                               '--img-h', str(HW[0]), '--img-w', str(HW[1])])
        roots[name] = root
    # The JAX loader keeps its maps by scene token, camera and size, which
    # every synthetic dataroot shares.
    jax_image._REMAP_CACHE.clear()
    return roots


@pytest.fixture()
def no_cv2_decode(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError('OpenCV on the device-decode path')

    for name in ('imread', 'imdecode'):
        monkeypatch.setattr(cv2, name, forbidden)
    return monkeypatch


@pytest.mark.parametrize('target', [None, (48, 80)], ids=['divisor', 'target'])
@pytest.mark.parametrize('name', ['plain', 'distorted'])
def test_fast_device_decode_matches_jax(dataroots, name, target,
                                        no_cv2_decode):
    jax_image._REMAP_CACHE.clear()
    ds = NewScenesDetDataset(
        f'{dataroots[name]}/synth_infos_temporal_val.pkl', modality='camera',
        use_camera=True, test_mode=True, image_decode='device',
        image_fast_decode=True, image_target_hw=target)
    outs = [(batch, IL.decode_camera_batch(batch, 'cpu'))
            for batch, _ in EvalLoader(ds, 2)]
    assert outs
    no_cv2_decode.undo()            # the JAX reference reads with OpenCV
    for batch, out in outs:
        assert not set(IL.CAMERA_SOURCE_KEYS) & set(out)
        for j, idx in enumerate(batch['index']):
            want = jax_image.load_camera_data(ds.infos[int(idx)],
                                              target_hw=target,
                                              fast_decode=True)
            for k in ('lidar2img', 'img2lidar_rots', 'img2lidar_trans'):
                np.testing.assert_array_equal(out[k][j], want[k])
            got = out['imgs'][j].numpy()
            assert got.shape == want['imgs'].shape
            assert np.abs(got - want['imgs']).max() <= 1e-5


def test_fast_training_batch_matches_jax(dataroots, no_cv2_decode):
    kw = dict(modality='camera', use_camera=True, load_depth_gt=True,
              image_fast_decode=True, max_gt=16, seed=3,
              aug={'photometric': True, 'rot_scale_flip_image': {},
                   'crop_resize_flip': {'resize': [28, 32],
                                        'crop': (4, 2, 52, 26),
                                        'rand_flip': True}})
    ann = f'{dataroots["distorted"]}/synth_infos_temporal_train.pkl'
    got_ds = NewScenesDetDataset(ann, image_decode='device', **kw)
    samples = [got_ds[i] for i in range(len(got_ds))]
    assert len(samples) >= 2
    imgs = IL.decode_camera_batch(collate(samples), 'cpu')['imgs']
    no_cv2_decode.undo()
    jax_image._REMAP_CACHE.clear()
    want_ds = JaxDataset(ann_file=ann, **kw)
    for i, got in enumerate(samples):
        want = want_ds[i]
        assert set(got) - set(IL.HOST_KEYS) == set(want) - {'imgs'}
        for k in want:
            if k != 'imgs':
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert imgs[i].shape == want['imgs'].shape
        err = np.abs(imgs[i].numpy() - want['imgs']).max()
        assert err <= 1e-5 * np.abs(want['imgs']).max()
