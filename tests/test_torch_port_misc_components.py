"""The port's smaller modules against the JAX package's:

* ``data/beam_reduction.py``: the same kept points, bit for bit (both
  NumPy in f64), for every beam subset;
* ``ops/chamfer.py``: within 1e-6 of JAX (f32 clouds), identical for any
  ``chunk`` (minima are exact), zero on identical clouds, 3 at a unit
  offset in each coordinate;
* ``utils/timing.py``: ``run_time`` / ``timing_stats`` /
  ``reset_timing_stats`` as JAX's, and ``device_trace`` writing a Chrome
  trace that holds the traced ops;
* ``tools/analyze_logs.py`` on the ``train.log.json`` of a port training
  run (``tools.train`` on a synthetic dataroot): the records and the
  printed iteration times equal JAX's tool's on the same file, and the
  curve is drawn;
* ``tools/misc.py``: ``print_config`` prints JAX's text; ``browse_dataset``
  writes its BEV previews;
* ``tools/visualize.py``: the drawings equal JAX's pixel for pixel, and
  the CLI writes its BEV plot;
* ``tools/download.py`` over ``file://`` URLs: a fresh download, a resume
  from a ``.part`` (``file://`` ignores the Range header, so the resume
  skips what the part holds), and a part longer than the file refused by
  the size check.
"""

import contextlib
import io
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.data import beam_reduction as jax_beams
from omnihd_scenes_tpu.ops.chamfer import (
    chamfer_distance as jax_chamfer_distance)
from omnihd_scenes_tpu.tools import analyze_logs as jax_analyze_logs
from omnihd_scenes_tpu.tools import misc as jax_misc
from omnihd_scenes_tpu.tools import visualize as jax_visualize
from omnihd_scenes_tpu.utils import timing as jax_timing
from omnihd_scenes_tpu_torch.data.beam_reduction import (BEAM_RANGE_DEG,
                                                         reduce_lidar_beams)
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)
from omnihd_scenes_tpu_torch.ops.chamfer import chamfer_distance
from omnihd_scenes_tpu_torch.tools import analyze_logs, download, misc
from omnihd_scenes_tpu_torch.tools import train as train_cli
from omnihd_scenes_tpu_torch.tools import visualize
from omnihd_scenes_tpu_torch.utils import timing

SYNTH = 'configs/synthetic/pointpillars_radar_synth.py'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=20000, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 4), np.float32)
    r = rng.uniform(5, 60, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(rng.choice(BEAM_RANGE_DEG, n))
    pts[:, 0] = r * np.cos(el) * np.cos(az) + 1.26
    pts[:, 1] = r * np.cos(el) * np.sin(az)
    pts[:, 2] = r * np.sin(el) + 1.855
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.mark.parametrize('beams', [64, 32, 16, 4, 8])
def test_beam_reduction_matches_jax(beams):
    pts = _cloud()
    got = reduce_lidar_beams(pts, beams)
    want = jax_beams.reduce_lidar_beams(pts, beams)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(pts)
    if beams == 64:
        assert 0.3 < len(got) / len(pts) < 0.7


def test_beam_reduction_ratios_and_features():
    pts = _cloud()
    n = [len(reduce_lidar_beams(pts, b)) for b in (64, 32, 16, 4)]
    assert n[0] > n[1] > n[2] > n[3] > 0 and n[3] / len(pts) < 0.1
    pts[:, 3] = 7.0
    assert np.all(reduce_lidar_beams(pts, 32)[:, 3] == 7.0)


@pytest.mark.parametrize('n,m', [(100, 77), (1000, 1500)])
def test_chamfer_matches_jax_and_ignores_the_chunk(n, m):
    rng = np.random.RandomState(1)
    a = rng.randn(n, 3).astype(np.float32)
    b = (rng.randn(m, 3) * 1.5 + 0.2).astype(np.float32)
    want = [float(x) for x in jax_chamfer_distance(jnp.asarray(a),
                                                   jnp.asarray(b))]
    got = {chunk: chamfer_distance(torch.from_numpy(a), torch.from_numpy(b),
                                   chunk=chunk) for chunk in (16, 333, 4096)}
    for chunk, (ab, ba) in got.items():
        assert ab.dtype == torch.float32
        np.testing.assert_allclose([ab.item(), ba.item()], want, rtol=0,
                                   atol=1e-6)
        assert (ab.item(), ba.item()) == (got[16][0].item(),
                                          got[16][1].item()), chunk


def test_chamfer_identical_and_offset_clouds():
    a = torch.from_numpy(np.random.RandomState(0).randn(100, 3))
    d_ab, d_ba = chamfer_distance(a, a)
    assert d_ab.item() == 0.0 and d_ba.item() == 0.0
    d_ab, d_ba = chamfer_distance(torch.zeros(4, 3), torch.ones(4, 3))
    assert d_ab.item() == d_ba.item() == 3.0


def test_timing_stats_as_jax():
    stats = []
    for mod in (timing, jax_timing):
        mod.reset_timing_stats()
        fn = mod.run_time('add')(lambda x, y: x + y)
        assert fn(2, 3) == 5 and fn(1, 1) == 2
        s = mod.timing_stats()
        assert set(s) == {'add'} and s['add']['calls'] == 2
        assert s['add']['mean_ms'] == pytest.approx(
            s['add']['total_s'] / 2 * 1e3)
        stats.append({k: set(v) for k, v in s.items()})
        mod.reset_timing_stats()
        assert mod.timing_stats() == {}
    assert stats[0] == stats[1]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with timing.device_trace(str(tmp_path / 'trace')) as prof:
        (x @ x).sum()
    files = os.listdir(tmp_path / 'trace')
    assert len(files) == 1 and files[0].endswith('.json')
    trace = json.loads((tmp_path / 'trace' / files[0]).read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'aten::mm' in names
    assert any(e.key == 'aten::mm' for e in prof.key_averages())


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('misc_synth'))
    generate(root, 'v1.0-mini', SyntheticConfig(), images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def _options(root):
    return [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']


@pytest.fixture(scope='module')
def train_log(dataroot, tmp_path_factory):
    work = str(tmp_path_factory.mktemp('misc_work'))
    torch.manual_seed(0)
    train_cli.main([os.path.join(ROOT, SYNTH), '--work-dir', work,
                    '--device', 'cpu', '--no-validate', '--cfg-options',
                    *_options(dataroot), 'log_interval=1'])
    return os.path.join(work, 'train.log.json')


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_analyze_logs_on_a_port_training_log(train_log, tmp_path):
    records = analyze_logs.load_json_log(train_log)
    assert records == jax_analyze_logs.load_json_log(train_log)
    train = [r for r in records if r.get('mode') == 'train']
    assert len(train) >= 4 and all('loss' in r for r in train)
    text = _printed(analyze_logs.cal_train_time, records)
    assert text == _printed(jax_analyze_logs.cal_train_time, records)
    assert text.startswith('slowest iter time')
    out = str(tmp_path / 'curve.png')
    analyze_logs.main(['plot_curve', train_log, '--keys', 'loss',
                       'loss_cls', '--out', out])
    assert os.path.getsize(out) > 1000


def test_print_config_prints_jax_text(dataroot):
    args = types.SimpleNamespace(config=os.path.join(ROOT, SYNTH),
                                 cfg_options=_options(dataroot))
    text = _printed(misc.print_config, args)
    assert text == _printed(jax_misc.print_config, args)
    assert 'pfn_channels' in text and dataroot in text


def test_browse_dataset_writes_previews(dataroot, tmp_path):
    out = tmp_path / 'browse'
    misc.main(['browse_dataset', os.path.join(ROOT, SYNTH), '--out-dir',
               str(out), '--num', '2', '--cfg-options', *_options(dataroot)])
    assert sorted(os.listdir(out)) == ['sample_0.png', 'sample_1.png']
    assert all((out / f).stat().st_size > 1000 for f in os.listdir(out))


def _image_case():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (90, 160, 3)).astype(np.uint8)
    l2i = np.array([[80.0, 60.0, 0, 0], [45.0, 0, -60.0, 0],
                    [1.0, 0, 0, 0], [0, 0, 0, 1]])
    pts = np.concatenate([rng.uniform(2, 40, (300, 1)),
                          rng.uniform(-20, 20, (300, 2))], 1)
    boxes = np.array([[10.0, 1.0, -1.0, 2.0, 4.0, 1.6, 0.3, 0, 0],
                      [20.0, -3.0, -0.8, 1.8, 4.5, 1.5, -1.0, 0, 0],
                      [-5.0, 0.0, -1.0, 2.0, 4.0, 1.5, 0.0, 0, 0]])
    return img, l2i, pts, boxes


def test_visualize_drawings_equal_jax():
    img, l2i, pts, boxes = _image_case()
    for b in boxes:
        np.testing.assert_array_equal(visualize.box9_corners(b),
                                      jax_visualize.box9_corners(b))
    got = visualize.project_pts_on_img(img, pts, l2i)
    np.testing.assert_array_equal(
        got, jax_visualize.project_pts_on_img(img, pts, l2i))
    assert (got != img).any()
    got = visualize.draw_boxes3d_on_img(img, boxes, l2i)
    np.testing.assert_array_equal(
        got, jax_visualize.draw_boxes3d_on_img(img, boxes, l2i))
    assert (got != img).any()


def test_visualize_cli_and_draw_bev(dataroot, tmp_path):
    out = tmp_path / 'vis'
    visualize.main(['--ann-file',
                    f'{dataroot}/synth_infos_temporal_val.pkl',
                    '--out-dir', str(out)])
    assert (out / 'bev_0.png').stat().st_size > 1000
    _, _, pts, boxes = _image_case()
    path = visualize.draw_bev(pts, boxes, boxes[:1],
                              out=str(tmp_path / 'bev.png'))
    assert os.path.getsize(path) > 1000


def _key_file(tmp_path, files):
    spec = {'files': [{'url': src.as_uri(), 'path': name}
                      for name, src in files.items()]}
    path = tmp_path / 'keys.json'
    path.write_text(json.dumps(spec))
    return str(path)


def test_download_resumes_over_file_urls(tmp_path):
    rng = np.random.RandomState(0)
    src = {name: tmp_path / f'src_{name}' for name in ('a.bin', 'b.bin',
                                                       'c.bin')}
    data = {}
    for name, path in src.items():
        data[name] = rng.bytes(3 * (1 << 20) + 12345)
        path.write_bytes(data[name])
    out = tmp_path / 'out'
    out.mkdir()
    # a: fresh; b: a part of its first 1.5 MB; c: a part longer than the
    # file, which the size check refuses (the part is kept).
    (out / 'b.bin.part').write_bytes(data['b.bin'][:3 << 19])
    (out / 'c.bin.part').write_bytes(data['c.bin'] + b'extra')
    text = _printed(download.main, ['--key-file', _key_file(tmp_path, src),
                                    '--out-dir', str(out), '--workers', '2'])
    for name in ('a.bin', 'b.bin'):
        assert (out / name).read_bytes() == data[name]
        assert not (out / f'{name}.part').exists()
    assert not (out / 'c.bin').exists()
    assert (out / 'c.bin.part').exists()
    assert 'FAILED c.bin' in text and 'server announced' in text
