"""The card's camera decode path, run on the CPU through its plain forms,
against OpenCV and the JAX package's ``load_camera_data``.

* ``data/undistort.py`` against ``cv2.initUndistortRectifyMap``: the f32
  maps within 1e-3 px, the ``CV_16SC2`` maps equal on at least 99.99 % of
  the pixels and the rest within one 1/32-px step;
* the rectify kernel's plain passes (``kernels/rectify.py``) against
  ``cv2.remap`` and ``cv2.resize`` (u8 equal at 0.5, f32 within 1e-5 at
  0.5 and 0.8), and its YCbCr -> BGR pass against libjpeg (Pillow's YCbCr
  decode of the fixtures, converted, equals ``cv2.imdecode``); the plain
  versions of its setup kernels (packed map, tile footprints, resize
  taps) against what the chain reads;
* ``load_camera_data(decode='device')`` + ``decode_camera_batch(...,
  'cpu')`` (the host entropy decode and the kernels' plain versions, no
  ``cv2.imdecode``) against JAX's ``load_camera_data``, with and without
  distortion, padded to a target and to the divisor: ``lidar2img`` and
  ``img2lidar_*`` bit-equal, ``imgs`` within 1e-5 but on pixels whose
  fixed-point map entry differs from OpenCV's (none here), which may move
  by one u8 level (1 / std);
* the collated JPEG bytes (offsets rebased) through ``TrainLoader``'s
  worker pool equal the inline batches; the streaming and the batched
  eval runners give the host path's detections from a device-decode
  dataset;
* the generator's NumPy polygon fill against ``cv2.fillConvexPoly`` off a
  one-pixel band; the JPEG fixtures' script reproduces them; what the
  card cannot decode is refused.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from omnihd_scenes_tpu.data.image_loading import (  # noqa: E402
    load_camera_data as jax_load_camera_data)
from omnihd_scenes_tpu_torch.data import image_loading as IL  # noqa: E402
from omnihd_scenes_tpu_torch.data.dataset import (  # noqa: E402
    NewScenesDetDataset)
from omnihd_scenes_tpu_torch.data.jpeg import (  # noqa: E402
    check_card_decodable, jpeg_header)
from omnihd_scenes_tpu_torch.data.loader import (  # noqa: E402
    EvalLoader, TrainLoader, collate)
from omnihd_scenes_tpu_torch.data.undistort import (  # noqa: E402
    fixed_point_map, to_cv16sc2, undistort_map)
from omnihd_scenes_tpu_torch.devkit.converter import (  # noqa: E402
    create_newscenes_infos)
from omnihd_scenes_tpu_torch.devkit.synthetic import (  # noqa: E402
    SyntheticConfig, convex_hull, fill_convex_poly, generate)
from omnihd_scenes_tpu_torch.kernels import rectify as R  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / 'tests' / 'torch_port_fixtures'
DIST = (-0.05, 0.01, 1e-3, -1e-3, 0.0)
MEAN, STD = IL.IMAGENET_MEAN, IL.IMAGENET_STD


def _k(hw):
    h, w = hw
    return np.array([[w * 0.8, 0.0, w / 2.0], [0.0, w * 0.8, h / 2.0],
                     [0.0, 0.0, 1.0]])


@pytest.mark.parametrize('hw,dist', [
    ((1080, 1920), DIST), ((108, 192), (-0.3, 0.1, 0.0, 0.0, 0.0)),
    ((72, 128), (-0.05, 0.01, 1e-3, -1e-3, 0.002))])
def test_undistort_map_matches_cv2(hw, dist):
    k, d = _k(hw), np.asarray(dist)
    u, v = undistort_map(k, d, hw)
    m1, m2 = cv2.initUndistortRectifyMap(k, d, None, k, hw[::-1],
                                         cv2.CV_32FC1)
    assert np.abs(u - m1).max() <= 1e-3 and np.abs(v - m2).max() <= 1e-3
    fixed = fixed_point_map(u, v)
    xy, frac = to_cv16sc2(fixed)
    cxy, cfrac = cv2.initUndistortRectifyMap(k, d, None, k, hw[::-1],
                                             cv2.CV_16SC2)
    same = (xy == cxy).all(-1) & (frac == cfrac)
    assert same.mean() >= 0.9999
    cxy, cfrac = cxy.astype(np.int64), cfrac.astype(np.int64)
    ref = np.stack([cxy[..., 0] * 32 + (cfrac & 31),
                    cxy[..., 1] * 32 + (cfrac >> 5)], -1)
    assert np.abs(fixed - ref).max() <= 1


@pytest.mark.parametrize('hw', [(72, 128), (108, 192)])
def test_rectify_plain_matches_cv2(hw):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    t = torch.from_numpy(img)
    fixed = fixed_point_map(*undistort_map(_k(hw), DIST, hw))
    np.testing.assert_array_equal(
        R.remap_u8_plain(t, torch.from_numpy(fixed)).numpy(),
        cv2.remap(img, *to_cv16sc2(fixed), cv2.INTER_LINEAR))
    half = (hw[0] // 2, hw[1] // 2)
    np.testing.assert_array_equal(R.resize_u8_plain(t, half).numpy(),
                                  cv2.resize(img, half[::-1]))
    x = (img.astype(np.float32)[..., ::-1] - np.asarray(MEAN, np.float32)) \
        / np.asarray(STD, np.float32)
    for f in (0.5, 0.8):
        size = (int(hw[0] * f), int(hw[1] * f))
        target = (size[0] + 5, size[1] + 7)
        got = R.normalize_pad_plain([t], [size], target, MEAN, STD)[0]
        assert float(got[size[0]:].abs().max()) == 0.0
        assert float(got[:, size[1]:].abs().max()) == 0.0
        want = cv2.resize(x, size[::-1])
        assert np.abs(got[:size[0], :size[1]].numpy() - want).max() <= 1e-5


def _map(hw, dist=DIST):
    return torch.from_numpy(fixed_point_map(*undistort_map(_k(hw), dist,
                                                           hw)))


def test_pack_map_plain_holds_each_entry():
    """Each word of ``pack_map_plain`` unpacks, as ``csrc/rectify.cu``
    reads it, to its map entry's whole pixel (an 11-bit displacement from
    its own pixel) and 1/32-px fractions; a displacement of 1024 px or
    more wraps (``footprint_table`` marks such tiles)."""
    hw = (72, 128)
    fixed = _map(hw)
    fixed[3, 5] = torch.tensor([(5 + 1500) * 32 + 7, 3 * 32 + 9])
    p = R.pack_map_plain(fixed).long() & 0xFFFFFFFF
    assert p.shape == hw

    def signed11(v):
        return ((v & 2047) ^ 1024) - 1024

    e = fixed.long()
    x = signed11(p) + torch.arange(hw[1])
    y = signed11(p >> 11) + torch.arange(hw[0])[:, None]
    near = torch.ones(hw, dtype=torch.bool)
    near[3, 5] = False
    assert torch.equal(x[near], (e[..., 0] >> 5)[near])
    assert torch.equal(y, e[..., 1] >> 5)
    assert int(x[3, 5]) != 1505
    assert torch.equal((p >> 22) & 31, e[..., 0] & 31)
    assert torch.equal(p >> 27, e[..., 1] & 31)


@pytest.mark.parametrize('f', [0.5, 0.8, 1.0])
def test_resize_taps_plain_are_the_resize_taps(f):
    """``resize_taps_plain``: the f32 resize's taps of every output row and
    column (``_axis_taps``, as ``resize_f32_plain`` reads them), the last
    repeated 31 times."""
    u8 = (65, 97)
    out = (int(u8[0] * f), int(u8[1] * f))
    geo = R._geometry(*u8, R.CHROMA_420, u8, out, (64, 96))
    _, sy, sx = R.resize_scales(u8, out)
    for table, n, n_src, scale in zip(R.resize_taps_plain(geo, 'cpu'), out,
                                      u8, (sy, sx)):
        s0, s1, w = R._axis_taps(n, n_src, scale, 'cpu')
        assert table.dtype == torch.int32 and table.shape == (n + 31, 4)
        assert torch.equal(table[:n, 0].long(), s0)
        assert torch.equal(table[:n, 1].long(), s1)
        assert torch.equal(table[:n, 2].view(torch.float32), w)
        assert torch.equal(table[n:], table[n - 1:n].expand(31, 4))
        assert int(table[:, 3].abs().max()) == 0


def _u_reads(d, geo, axis):
    """The U (undistorted image) rows or columns that output rows or
    columns ``d`` read through the f32 resize and the u8 one: (taps,
    len(d))."""
    sizes, scales, *_ = geo
    u8h, u8w, kind, usy, usx, oh, ow, resize, fsy, fsx = scales
    n, n_u8 = sizes[axis], (u8h, u8w)[axis]
    s = [d]
    if resize:
        s = list(R._taps_at(d, n_u8, R._f64((fsy, fsx)[axis]))[:2])
    if kind == R._U8_AREA2:
        s = [2 * v for v in s] + [2 * v + 1 for v in s]
    elif kind == R._U8_BILINEAR:
        s = [t for v in s
             for t in R._taps_at(v, n, R._f64((usy, usx)[axis]))[:2]]
    return torch.stack(s)


@pytest.mark.parametrize('use_map', [False, True])
@pytest.mark.parametrize('u8_f,out_f', [(1.0, 0.5), (0.5, 0.5), (0.7, 0.8),
                                        (1.0, 1.0)])
def test_footprint_table_plain_covers_the_taps(u8_f, out_f, use_map):
    """``footprint_table_plain``: the content tiles (32 columns by 8r rows)
    cover the resized image on the canvas once; each tile's U rectangle is
    the least and largest U row and column its output pixels read through
    both resizes, and its footprint the least and largest map row and
    column over that rectangle (the rectangle less its last row and column
    without a map)."""
    hw = (65, 97)
    u8 = (int(hw[0] * u8_f), int(hw[1] * u8_f))
    out = (int(u8[0] * out_f), int(u8[1] * out_f))
    target = (out[0] + 3, out[1] - 5)
    geo = R._geometry(*hw, R.CHROMA_420, u8, out, target)
    fixed = _map(hw) if use_map else None
    table = R.footprint_table_plain(fixed, geo, target)
    _, _, r, content, _ = geo
    assert table.dtype == torch.int32 and table.shape == (2 * content, 4)
    rect, foot = table[0::2].long(), table[1::2].long()
    rows, cols = min(out[0], target[0]), min(out[1], target[1])
    tiles_x = -(-cols // 32)
    covered = torch.zeros((rows, cols), dtype=torch.int64)
    for t in range(content):
        y0, x0 = (t // tiles_x) * 8 * r, (t % tiles_x) * 32
        ys = torch.arange(y0, min(y0 + 8 * r, rows))
        xs = torch.arange(x0, min(x0 + 32, cols))
        covered[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] += 1
        ry, rx = _u_reads(ys, geo, 0), _u_reads(xs, geo, 1)
        a, b, c, d = rect[t].tolist()
        assert (a, b, c, d) == (int(ry.min()), int(ry.max()),
                                int(rx.min()), int(rx.max())), t
        if fixed is None:
            assert foot[t].tolist() == [a, b - 1, c, d - 1]
        else:
            e = fixed[a:b + 1, c:d + 1].long() >> 5
            assert foot[t].tolist() == [
                int(e[..., 1].min()), int(e[..., 1].max()),
                int(e[..., 0].min()), int(e[..., 0].max())], t
    assert int(covered.min()) == int(covered.max()) == 1


def test_ycbcr_pass_matches_libjpeg():
    """Pillow's libjpeg YCbCr decode of each fixture (chroma upsampled by
    libjpeg), through the plain YCbCr -> BGR pass at 4:4:4, equals
    ``cv2.imdecode``: the colour tables are libjpeg's; the plain
    upsampling keeps shapes and its 4:4:4 form is the identity."""
    image = pytest.importorskip('PIL.Image')
    for name in ('camera_1080p_420', 'noise_64x96_420', 'noise_64x96_444'):
        im = image.open(FIXTURES / 'jpeg' / f'{name}.jpg')
        im.draft('YCbCr', im.size)
        ycc = torch.from_numpy(np.array(im))
        got = R.ycbcr_to_bgr_plain(ycc[..., 0], ycc[..., 1], ycc[..., 2],
                                   R.CHROMA_444)
        want = np.load(FIXTURES / 'jpeg' / f'{name}.npz')['bgr']
        np.testing.assert_array_equal(got.numpy(), want)
    for mode, hw in ((R.CHROMA_422, (5, 7)), (R.CHROMA_420, (5, 7))):
        c = torch.arange(np.prod(R.chroma_shape(hw, mode)),
                         dtype=torch.uint8).reshape(R.chroma_shape(hw, mode))
        up = R.upsample_chroma_plain(c, hw, mode)
        assert tuple(up.shape) == hw and int(up[0, 0]) == int(c[0, 0])


@pytest.fixture(scope='module')
def dataroots(tmp_path_factory):
    """Two dataroots with images (the JAX generator's JPEGs), without and
    with lens distortion, and their infos."""
    roots = {}
    for name, dist in (('plain', (0.0,) * 5), ('distorted', DIST)):
        root = str(tmp_path_factory.mktemp(f'decode_{name}'))
        generate(root, 'v1.0-mini', SyntheticConfig(
            n_scenes=2, samples_per_scene=2, image_hw=(72, 128),
            n_radar_points=32, cam_distortion=dist))
        create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                               max_sweeps=0)
        roots[name] = root
    return roots


def _dataset(root, decode, **kw):
    return NewScenesDetDataset(f'{root}/synth_infos_temporal_val.pkl',
                               modality='camera', use_camera=True,
                               test_mode=True, image_decode=decode, **kw)


@pytest.mark.parametrize('target', [None, (48, 80)], ids=['divisor', 'target'])
@pytest.mark.parametrize('name', ['plain', 'distorted'])
def test_device_decode_matches_jax(dataroots, name, target, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError('cv2.imdecode on the device-decode path')

    monkeypatch.setattr(cv2, 'imdecode', forbidden)
    ds = _dataset(dataroots[name], 'device', image_target_hw=target)
    for batch, valid in EvalLoader(ds, 2):
        out = IL.decode_camera_batch(batch, 'cpu')
        assert not set(IL.CAMERA_SOURCE_KEYS) & set(out)
        for j, idx in enumerate(batch['index']):
            want = jax_load_camera_data(ds.infos[int(idx)], target_hw=target)
            for k in ('lidar2img', 'img2lidar_rots', 'img2lidar_trans'):
                np.testing.assert_array_equal(out[k][j], want[k])
            assert out['imgs'][j].shape == want['imgs'].shape
            assert np.abs(out['imgs'][j].numpy() - want['imgs']).max() <= 1e-5


def test_worker_pool_carries_the_jpeg_bytes(dataroots):
    ds = _dataset(dataroots['distorted'], 'device')
    inline = list(TrainLoader(ds, 2, shuffle=False))
    loader = TrainLoader(ds, 2, shuffle=False, num_workers=2)
    try:
        pooled = list(loader)
    finally:
        loader.close()
    assert len(inline) == len(pooled) == 1
    for a, b in zip(inline, pooled):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    batch = inline[0]
    offsets = batch[IL.JPEG_OFFSETS]
    assert offsets.shape == (2, 7) and offsets[1, 0] == offsets[0, -1]
    assert offsets[-1, -1] == batch[IL.JPEG_BYTES].size
    whole = IL.decode_camera_batch(batch, 'cpu')['imgs']
    for j in range(2):
        one = IL.decode_camera_batch(collate([ds[j]]), 'cpu')
        assert torch.equal(whole[j], one['imgs'][0])


def _seeded(path, opts):
    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)
    from omnihd_scenes_tpu_torch.train.config import Config

    cfg = Config.fromfile(str(ROOT / path))
    cfg.merge_from_options(opts)
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    return cfg, model.eval(), mtype


def _opts(root):
    return [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ('boxes', 'scores', 'labels', 'valid'):
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_eval_runners_decode_device_batches(dataroots):
    """The batched runner (BEVFusion-OCC synthetic) and the streaming one
    (BEVFormer-T synthetic) give the host path's detections from a
    device-decode dataset decoded on the CPU."""
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        run_inference_generic, run_streaming_inference_batched)

    root = dataroots['distorted']
    cfg, model, mtype = _seeded('configs/synthetic/bevfusion_synth.py',
                                _opts(root))
    predict = make_predict_fn_generic(model, mtype, anchors_for(model, mtype))
    outs = [run_inference_generic(predict, model, build_dataset_single(
        cfg.data.val, 'det', image_decode=decode), 2)
        for decode in ('host', 'device')]
    _same_results(outs[0]['bbox_results'], outs[1]['bbox_results'])
    for a, b in zip(outs[0]['occ_results'], outs[1]['occ_results']):
        np.testing.assert_array_equal(a, b)

    cfg, model, _ = _seeded('configs/synthetic/bevformer_synth.py',
                            _opts(root))
    predict = make_predict_fn_generic(model, 'bevformer')
    shape = (model.cfg.bev_h * model.cfg.bev_w, model.cfg.embed_dims)
    with torch.inference_mode():
        streams = [run_streaming_inference_batched(
            predict, model, build_dataset_single(
                cfg.data.val, 'temporal', image_decode=decode), shape, 1)
            for decode in ('host', 'device')]
    _same_results(*streams)


def test_polygon_fill_matches_cv2_off_the_edges():
    rng = np.random.RandomState(0)

    def band(m):
        p = np.pad(m, 1, mode='edge')
        grown, shrunk = np.zeros_like(m), np.ones_like(m)
        for dy in range(3):
            for dx in range(3):
                s = p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
                grown |= s
                shrunk &= s
        return grown & ~shrunk

    for _ in range(100):
        pts = rng.randint(-50, 180, (8, 2)).astype(np.int32)
        a = np.zeros((72, 128, 3), np.uint8)
        b = a.copy()
        cv2.fillConvexPoly(a, cv2.convexHull(pts.reshape(-1, 1, 2)),
                           (10, 20, 30))
        fill_convex_poly(b, convex_hull(pts), (10, 20, 30))
        ma, mb = a[..., 0] > 0, b[..., 0] > 0
        assert not ((ma != mb) & ~(band(ma) | band(mb))).any()


def test_jpeg_fixtures_reproduce(tmp_path):
    subprocess.run([sys.executable, str(FIXTURES / 'make_jpeg_fixtures.py'),
                    str(tmp_path)], check=True, timeout=120)
    committed = sorted(p.name for p in (FIXTURES / 'jpeg').iterdir())
    assert sorted(os.listdir(tmp_path)) == committed
    assert sum((FIXTURES / 'jpeg' / n).stat().st_size
               for n in committed) < 1 << 20
    for name in committed:
        if name.endswith('.jpg'):
            assert (tmp_path / name).read_bytes() == (
                FIXTURES / 'jpeg' / name).read_bytes()
        else:
            np.testing.assert_array_equal(
                np.load(tmp_path / name)['bgr'],
                np.load(FIXTURES / 'jpeg' / name)['bgr'])


def test_headers_and_what_the_card_refuses():
    img = np.random.RandomState(1).randint(0, 256, (33, 47, 3)).astype(
        np.uint8)
    for flag, mode in ((cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, R.CHROMA_444),
                       (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, R.CHROMA_422),
                       (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, R.CHROMA_420)):
        data = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          flag])[1]
        h = jpeg_header(data)
        assert (h.height, h.width, h.components, h.chroma) == (33, 47, 3,
                                                               mode)
        check_card_decodable([h])
    progressive = jpeg_header(cv2.imencode(
        '.jpg', img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1])
    with pytest.raises(ValueError, match='progressive'):
        check_card_decodable([progressive])
    gray = jpeg_header(cv2.imencode('.jpg', img[..., 0])[1])
    with pytest.raises(ValueError, match='components'):
        check_card_decodable([gray])
    with pytest.raises(ValueError, match='not a JPEG'):
        jpeg_header(b'\x00\x01\x02\x03')


def test_device_decode_refusals(dataroots):
    root = dataroots['plain']
    ds = _dataset(root, 'host')
    with pytest.raises(ValueError, match='decode'):
        IL.load_camera_data(ds.infos[0], decode='gpu')
    # The reduced-DCT fast decode is no longer refused: its sources carry
    # each camera's net scale.
    fast = IL.load_camera_data(ds.infos[0], fast_decode=True,
                               decode='device')
    np.testing.assert_array_equal(fast['cam_scales'][:, 2], [
        0.25 if cam in ('camera_front', 'camera_back') else 0.5
        for cam in ds.infos[0]['cams']])
    # Training, depth targets and the fast decode take the device decode;
    # another decode name stays refused.
    for kw in (dict(test_mode=False), dict(test_mode=True,
                                           load_depth_gt=True)):
        for fast_decode in (False, True):
            ds = NewScenesDetDataset(f'{root}/synth_infos_temporal_val.pkl',
                                     modality='camera', use_camera=True,
                                     image_decode='device',
                                     image_fast_decode=fast_decode, **kw)
            assert ds.image_decode == 'device'
        with pytest.raises(ValueError, match='image_decode'):
            NewScenesDetDataset(f'{root}/synth_infos_temporal_val.pkl',
                                modality='camera', use_camera=True,
                                image_decode='gpu', **kw)
