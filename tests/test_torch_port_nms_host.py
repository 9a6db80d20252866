"""The host NMS of ``tools.test --host-nms`` against the JAX package's and
against the port's in-graph NMS, and the CLIs that reach it.

* ``ops/nms_host.py:nms_rotated_multiclass_host`` (the port's native C++
  core, ``csrc/host_ops.cpp``), its plain NumPy form and JAX's
  ``nms_rotated_multiclass_host`` keep the same rows as multisets; the
  port's in-graph ``ops/nms.py:multiclass_nms_rotated`` too, but where a
  pair's IoU sits within float tolerance of the threshold (JAX
  ``tests/test_nms_host.py``'s rule);
* ``make_predict_fn_generic(host_nms=True)`` returns the in-graph path's
  detections on a small PointPillars;
* ``tools.test --host-nms --device cpu --eval`` on the pillar synthetic
  config gives the metrics of the in-graph run, and BEVFormer ignores the
  flag; ``tools.benchmark --device cpu`` prints its FPS and stage lines.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops.nms_host import (
    nms_rotated_multiclass_host as jax_nms_host)
from omnihd_scenes_tpu_torch.config import PointPillarsConfig
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.ops.boxes3d import rotated_iou_bev
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.ops.nms_host import (
    _rotated_iou_np, greedy_kept, nms_rotated_multiclass_host,
    nms_rotated_multiclass_host_batch, nms_rotated_multiclass_plain,
    rotated_iou_matrix_plain)
from omnihd_scenes_tpu_torch.tools import benchmark as bench_cli
from omnihd_scenes_tpu_torch.tools import test as test_cli
from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                   init_model,
                                                   make_predict_fn_generic)
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                save_checkpoint)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNTH = str(ROOT / 'configs/synthetic/pointpillars_radar_synth.py')
BEVFORMER_SYNTH = str(ROOT / 'configs/synthetic/bevformer_synth.py')
SCORE_THR, IOU_THR, MAX_NUM = 0.05, 0.2, 500


def _candidates(seed, n=200, c=4, spread=30.0):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = rng.uniform(-spread, spread, n)
    boxes[:, 1] = rng.uniform(-spread * 2 / 3, spread * 2 / 3, n)
    boxes[:, 2] = rng.uniform(-2, 0, n)
    boxes[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7:9] = rng.randn(n, 2)
    scores = rng.uniform(0, 1, (n, c)).astype(np.float32)
    scores *= rng.uniform(0, 0.4, (n, 1))
    return boxes, scores


def _rows(out):
    """Multiset (sorted list) of kept (label, box, score) rows."""
    boxes, scores, labels, valid = (np.asarray(x) for x in out)
    return sorted((int(l), tuple(b.tolist()), float(s))
                  for b, s, l, v in zip(boxes, scores, labels, valid) if v)


@pytest.mark.parametrize('seed', range(4))
def test_native_core_matches_jax_and_the_plain_form(seed):
    boxes, scores = _candidates(seed)
    port = nms_rotated_multiclass_host(boxes, scores, SCORE_THR, IOU_THR,
                                       MAX_NUM)
    assert port[0].shape == (MAX_NUM, 9) and port[2].dtype == np.int32
    assert _rows(port) == _rows(jax_nms_host(boxes, scores, SCORE_THR,
                                             IOU_THR, MAX_NUM))
    assert _rows(port) == _rows(nms_rotated_multiclass_plain(
        boxes, scores, SCORE_THR, IOU_THR, MAX_NUM))


@pytest.mark.parametrize('spread', [2.0, 30.0])
def test_iou_matrix_is_the_plain_forms_iou(spread):
    """The vectorised f64 IoU matrix equals the plain form's pairwise IoU
    (same clipping, same order of box and planes) to f64 rounding, on a
    dense and a sparse set with duplicated and axis-aligned boxes, across
    chunk boundaries."""
    boxes, _ = _candidates(5, n=45, spread=spread)
    boxes[::5, 6] = 0.0
    boxes[1::5] = boxes[0::5][:len(boxes[1::5])]
    got = rotated_iou_matrix_plain(torch.from_numpy(boxes),
                                   rows_per_chunk=7).numpy()
    want = np.array([[_rotated_iou_np(boxes[k], boxes[i])
                      for i in range(len(boxes))] for k in range(len(boxes))])
    assert np.abs(got - want).max() < 1e-12
    assert (want > 0).sum() > len(boxes)


@pytest.mark.parametrize('seed', range(2))
def test_native_core_is_greedy_over_the_f64_iou_matrix(seed):
    """The native core keeps exactly the rows of a greedy pass over the
    f64 IoU matrix (the card's smoke holds it so on its candidates)."""
    boxes, scores = _candidates(seed)
    iou = rotated_iou_matrix_plain(torch.from_numpy(boxes)).numpy()
    assert not np.any(np.abs(iou - IOU_THR) < 1e-9)
    rows = sorted((cl, tuple(boxes[i].tolist()), sc) for cl, i, sc in
                  greedy_kept(iou > IOU_THR, scores, SCORE_THR, MAX_NUM))
    assert rows == _rows(nms_rotated_multiclass_host(
        boxes, scores, SCORE_THR, IOU_THR, MAX_NUM))


@pytest.mark.parametrize('seed', range(4))
def test_native_core_matches_the_in_graph_nms(seed):
    boxes, scores = _candidates(seed)
    graph = multiclass_nms_rotated(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), SCORE_THR,
                                   IOU_THR, MAX_NUM)
    host = nms_rotated_multiclass_host(boxes, scores, SCORE_THR, IOU_THR,
                                       MAX_NUM)
    g, h = set(_rows(graph)), set(_rows(host))
    if g != h:      # only a pair at the threshold may decide otherwise
        iou = rotated_iou_bev(torch.from_numpy(boxes),
                              torch.from_numpy(boxes)).numpy()
        assert np.any(np.abs(iou - IOU_THR) < 1e-3), g ^ h


def test_dense_cluster_and_empty_batch():
    rng = np.random.RandomState(7)
    n = 120
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, :2] = rng.uniform(-1, 1, (n, 2))
    boxes[:, 3:6] = 4.0
    boxes[:, 6] = rng.uniform(-0.1, 0.1, n)
    scores = rng.uniform(0.1, 0.9, (n, 2)).astype(np.float32)
    graph = multiclass_nms_rotated(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), SCORE_THR,
                                   IOU_THR, 32)
    host = nms_rotated_multiclass_host_batch(
        np.stack([boxes, boxes]), np.stack([scores, scores * 0 + 0.01]),
        SCORE_THR, IOU_THR, 32)
    assert _rows(graph) == _rows(tuple(x[0] for x in host))
    assert not host[3][1].any() and np.all(host[0][1] == 0)


def test_predict_fn_host_nms_matches_in_graph():
    cfg = PointPillarsConfig(
        point_cloud_range=(-10, -10, -3.0, 10, 10, 5.0),
        voxel_size=(2.0, 2.0, 8.0), max_voxels=64, max_points_per_voxel=4,
        bev_hw=(10, 10), pfn_channels=(8,), second_channels=(8, 8, 8),
        fpn_channels=(8, 8, 8))
    model = PointPillars(cfg, 8)
    init_model(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {'points': rng.uniform(-9, 9, (2, 64, 8)).astype(np.float32),
             'points_mask': np.ones((2, 64), bool)}
    graph = make_predict_fn_generic(model, 'pointpillars', cfg.anchors())
    host = make_predict_fn_generic(model, 'pointpillars', cfg.anchors(),
                                   host_nms=True)
    (g_dets, g_occ), (h_dets, h_occ) = graph(model, batch), host(model, batch)
    assert g_occ is None and h_occ is None
    assert all(not t.is_cuda for t in h_dets)
    for sample in range(2):
        g = _rows(tuple(t[sample] for t in g_dets))
        assert g and g == _rows(tuple(t[sample] for t in h_dets))


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    """A radar dataroot without images, and a checkpoint of the pillar
    synthetic config's seeded weights."""
    root = str(tmp_path_factory.mktemp('nms_synth'))
    generate(root, 'v1.0-mini', SyntheticConfig(samples_per_scene=2),
             images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    opts = [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']
    cfg = Config.fromfile(SYNTH)
    cfg.merge_from_options(opts)
    model, _ = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    ckpt = os.path.join(root, 'ckpts')
    save_checkpoint(ckpt, create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(1e-3, 100, warmup_iters=10))), 1)
    return ckpt, opts


def test_test_cli_host_nms_gives_the_in_graph_metrics(checkpoint, tmp_path,
                                                      capsys):
    ckpt, opts = checkpoint
    runs = {}
    for name, extra in (('graph', []), ('host', ['--host-nms'])):
        out = str(tmp_path / name)
        runs[name] = test_cli.main([SYNTH, ckpt, '--eval', '--out-dir', out,
                                    '--device', 'cpu', *extra,
                                    '--cfg-options', *opts])
        with open(os.path.join(out, 'results_newsc.json')) as f:
            runs[name + '_rows'] = {
                tok: sorted(json.dumps(r, sort_keys=True) for r in rows)
                for tok, rows in json.load(f)['results'].items()}
    assert runs['graph'] == runs['host']
    assert runs['graph_rows'] == runs['host_rows']
    assert sum(map(len, runs['host_rows'].values())) > 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('kernel launches ')
    assert json.loads(last[len('kernel launches '):])['lss_sample_bev'] == 0


def test_test_cli_host_nms_is_ignored_for_bevformer(capsys):
    args = test_cli.parse_args([BEVFORMER_SYNTH, 'ckpt', '--eval',
                                '--host-nms'])
    assert args.host_nms


def test_benchmark_cli_prints_fps_on_the_cpu(checkpoint, capsys):
    ckpt, opts = checkpoint
    result = bench_cli.main([SYNTH, '--checkpoint', ckpt, '--samples', '2',
                             '--warmup', '1', '--device', 'cpu',
                             '--cfg-options', *opts])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith('Overall fps: ') and 'samples/sec' in out[0]
    assert out[1].startswith('ms/sample: load ')
    assert json.loads(out[2]) == result
    assert result['samples'] == 2 and result['fps'] > 0
    assert result['device'] == 'cpu' and result['decode'] is None
    assert set(result['ms_per_sample']) == {'load', 'upload', 'decode',
                                            'model'}
