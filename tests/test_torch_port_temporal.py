"""BEVFormer's data and eval path on the port against the JAX package, on
the CPU, over a synthetic dataroot with camera JPEGs (OpenCV):

* ``finalize_can_bus`` and the temporal dataset's samples bit-equal to
  JAX's, in test mode and in queue mode (``union2one`` deltas and
  scene-boundary flags, the same seeded frame drops);
* ``StreamingEvalState`` over the val sequence equal to JAX's;
* the streaming runner on ``configs/synthetic/bevformer_synth.py``'s
  model against JAX's runners on the same (bridged) weights, each
  sample's kept boxes matched as multisets within 1e-4: one stream, B
  scene-parallel streams against JAX's one stream per block, and two
  streams against JAX's batched runner;
* the SCA-cap preflight's count equal to JAX's over the same rigs;
* ``tools.test --eval`` end to end with ``--device cpu`` from a port
  checkpoint of those weights, one stream and two: the result JSON and a
  finite metric dict.
"""

import json
import math
import os
import pathlib
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

import jax  # noqa: E402

from omnihd_scenes_tpu.data import temporal_dataset as jax_td  # noqa: E402
from omnihd_scenes_tpu.models.bevformer.detector import (  # noqa: E402
    BEVFormerConfig as JaxCfg, BEVFormerDetector as JaxDetector,
    sca_overflow_for_rig as jax_sca_overflow_for_rig)
from omnihd_scenes_tpu.train.builder import (  # noqa: E402
    make_predict_fn_generic as jax_make_predict_fn,
    make_predict_stream_batched as jax_make_predict_batched)
from omnihd_scenes_tpu.train.eval_runner import (  # noqa: E402
    run_streaming_inference as jax_run_streaming,
    run_streaming_inference_batched as jax_run_streaming_batched)
from omnihd_scenes_tpu_torch.config import BEVFormerConfig  # noqa: E402
from omnihd_scenes_tpu_torch.data import temporal_dataset  # noqa: E402
from omnihd_scenes_tpu_torch.devkit.converter import (  # noqa: E402
    create_newscenes_infos)
from omnihd_scenes_tpu_torch.devkit.synthetic import (  # noqa: E402
    SyntheticConfig, generate)
from omnihd_scenes_tpu_torch.models.bevformer import (  # noqa: E402
    BEVFormerDetector)
from omnihd_scenes_tpu_torch.tools import benchmark as bench_cli  # noqa: E402
from omnihd_scenes_tpu_torch.tools import test as test_cli  # noqa: E402
from omnihd_scenes_tpu_torch.train.builder import (  # noqa: E402
    build_model_from_cfg, make_predict_fn_generic)
from omnihd_scenes_tpu_torch.train.config import Config  # noqa: E402
from omnihd_scenes_tpu_torch.train.eval_runner import (  # noqa: E402
    run_streaming_inference, run_streaming_inference_batched)
from omnihd_scenes_tpu_torch.train.loop import (  # noqa: E402
    create_train_state, save_checkpoint)
from omnihd_scenes_tpu_torch.train.optim import (  # noqa: E402
    make_lr_schedule, make_optimizer)
from omnihd_scenes_tpu_torch.weights import (  # noqa: E402
    flax_to_torch, load_state_dict)
from tests.test_torch_port_bevformer import (  # noqa: E402
    assert_same_detections, bridged_variables)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNTH_CFG = str(ROOT / 'configs/synthetic/bevformer_synth.py')


def cfg_options(root):
    return [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']


@pytest.fixture(scope='module')
def cfg(dataroot):
    c = Config.fromfile(SYNTH_CFG)
    c.merge_from_options(cfg_options(dataroot))
    return c


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('bevformer_synth'))
    # Two scenes per split, three samples each: the val stream and the
    # train queues cross a scene boundary.
    generate(root, 'v1.0-mini', SyntheticConfig(n_scenes=4,
                                                samples_per_scene=3),
             images=True)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def _datasets(cfg, split):
    kw = dict(cfg.data[split])
    return (temporal_dataset.TemporalNewScenesDataset(**kw),
            jax_td.TemporalNewScenesDataset(**kw))


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_can_bus_and_test_samples_equal_jax(cfg):
    port, jax_ds = _datasets(cfg, 'val')
    assert len(port) == len(jax_ds) > 3
    for info in port.infos:
        np.testing.assert_array_equal(temporal_dataset.finalize_can_bus(info),
                                      jax_td.finalize_can_bus(info))
    for i in (0, len(port) - 1):
        _assert_samples_equal(port[i], jax_ds[i])


def test_queue_samples_equal_jax(cfg):
    """Queue mode: the same seeded frame drops, the deltas and flags of
    ``union2one``, at the start, across the scene boundary and after it."""
    port, jax_ds = _datasets(cfg, 'train')
    scenes = [i['scene_token'] for i in port.infos]
    first = next(i for i in range(1, len(scenes))
                 if scenes[i] != scenes[i - 1])
    for i in (0, first, first + 1):
        got, want = port[i], jax_ds[i]
        _assert_samples_equal(got, want)
    assert not got['has_prev'][0] and got['has_prev'][-1]


def test_streaming_state_equals_jax(cfg):
    port, _ = _datasets(cfg, 'val')
    mine = temporal_dataset.StreamingEvalState((4, 2))
    theirs = jax_td.StreamingEvalState((4, 2))
    for info in port.infos + port.infos[:2]:
        cb = temporal_dataset.finalize_can_bus(info)
        got, want = (s.prepare(cb, info['scene_token'])
                     for s in (mine, theirs))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        mine.update(np.ones((4, 2)))
        theirs.update(np.ones((4, 2)))


@pytest.fixture(scope='module')
def weights(cfg):
    mcfg = BEVFormerConfig(**cfg.model.to_dict())
    variables = bridged_variables(mcfg, seed=4)
    model = BEVFormerDetector(mcfg)
    load_state_dict(model, flax_to_torch(variables, mcfg))
    return mcfg, variables, model.eval()


def _bev_shape(mcfg):
    return (mcfg.bev_h * mcfg.bev_w, mcfg.embed_dims)


@pytest.fixture(scope='module')
def jax_model(cfg, weights):
    """JAX's detector and a train-state view of the bridged weights."""
    variables = weights[1]
    return (JaxDetector(JaxCfg(**cfg.model.to_dict())),
            types.SimpleNamespace(params=variables['params'],
                                  batch_stats=variables['batch_stats']))


@pytest.fixture(scope='module')
def jax_predict(jax_model):
    """JAX's one-stream predict function, jitted once for the module."""
    return jax_make_predict_fn(jax_model[0], 'bevformer')


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_detections(
            [g[k] for k in ('boxes', 'scores', 'labels', 'valid')],
            [w[k] for k in ('boxes', 'scores', 'labels', 'valid')])


def test_streaming_runner_equals_jax(cfg, weights, jax_model, jax_predict):
    mcfg, _, model = weights
    port, jax_ds = _datasets(cfg, 'val')
    want = jax_run_streaming(jax_predict, jax_model[1], jax_ds,
                             _bev_shape(mcfg))
    got = run_streaming_inference(make_predict_fn_generic(model, 'bevformer'),
                                  model, port, _bev_shape(mcfg))
    _assert_same_results(got, want)


class _Block:
    """Dataset rows [start, stop) as a dataset of their own."""

    def __init__(self, ds, start, stop):
        self.ds, self.start = ds, start
        self.infos = ds.infos[start:stop]

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, i):
        return self.ds[self.start + i]


@pytest.mark.parametrize('streams', [2, 3])
def test_batched_runner_equals_one_stream_per_block(cfg, weights, jax_model,
                                                    jax_predict, streams):
    """B scene-parallel streams on the port against JAX's one-stream
    runner over each stream's block of the dataset."""
    mcfg, _, model = weights
    port, jax_ds = _datasets(cfg, 'val')
    got = run_streaming_inference_batched(
        make_predict_fn_generic(model, 'bevformer'), model, port,
        _bev_shape(mcfg), streams)
    per = -(-len(port) // streams)
    want = []
    for s in range(streams):
        block = _Block(jax_ds, s * per, min((s + 1) * per, len(jax_ds)))
        if len(block):
            want += jax_run_streaming(jax_predict, jax_model[1], block,
                                      _bev_shape(mcfg))
    assert len(want) == len(port)
    _assert_same_results(got, want)


def test_batched_runner_equals_jax_batched(cfg, weights, jax_model):
    mcfg, _, model = weights
    port, jax_ds = _datasets(cfg, 'val')
    jm, state = jax_model
    want = jax_run_streaming_batched(jax_make_predict_batched(jm), state,
                                     jax_ds, _bev_shape(mcfg), 2)
    got = run_streaming_inference_batched(
        make_predict_fn_generic(model, 'bevformer'), model, port,
        _bev_shape(mcfg), 2)
    _assert_same_results(got, want)


def test_sca_cap_preflight_equals_jax(cfg, capsys):
    port, _ = _datasets(cfg, 'val')
    for cap in (1.0, 0.05):
        mcfg = BEVFormerConfig(**{**cfg.model.to_dict(),
                                  'sca_query_cap': cap})
        jcfg = JaxCfg(**{**cfg.model.to_dict(), 'sca_query_cap': cap})
        got = test_cli.sca_cap_preflight(mcfg, port)
        rigs = {}
        for info in port.infos:
            rigs.setdefault(info['scene_token'],
                            port._load_camera(info)['lidar2img'])
        assert got == sum(jax_sca_overflow_for_rig(jcfg, l2i)
                          for l2i in rigs.values())
        assert (got > 0) == (cap < 1.0)
        assert ('WARNING' in capsys.readouterr().out) == (cap < 1.0)


@pytest.fixture(scope='module')
def checkpoint(cfg, weights, tmp_path_factory):
    """A port checkpoint of the bridged weights, saved as training saves
    one."""
    model, mtype = build_model_from_cfg(cfg)
    assert mtype == 'bevformer'
    load_state_dict(model, weights[2].state_dict())
    state = create_train_state(model, lambda params: make_optimizer(
        params, make_lr_schedule(1e-3, 100, warmup_iters=10)))
    ckpt_dir = str(tmp_path_factory.mktemp('bevformer_ckpt'))
    save_checkpoint(ckpt_dir, state, 1)
    return ckpt_dir


@pytest.mark.parametrize('streams', [1, 2])
def test_test_cli_evaluates_bevformer(dataroot, checkpoint, tmp_path, streams,
                                      capsys):
    out = str(tmp_path / 'test')
    metrics = test_cli.main([
        SYNTH_CFG, checkpoint, '--eval', '--host-nms', '--out-dir', out,
        '--device', 'cpu', '--cfg-options', *cfg_options(dataroot),
        f'data.samples_per_device={streams}'])
    assert '--host-nms ignored' in capsys.readouterr().out
    assert math.isfinite(metrics['mAP']) and math.isfinite(metrics['NOS'])
    assert json.load(open(os.path.join(out, 'metrics.json'))) == metrics
    sub = json.load(open(os.path.join(out, 'results_newsc.json')))
    assert sub['meta']['use_camera'] and len(sub['results']) > 3


def test_benchmark_times_the_streaming_runner(cfg, dataroot, weights,
                                              checkpoint, capsys):
    """``tools.benchmark`` on BEVFormer times ``tools.test``'s streaming
    runner: its timer ends the run after the first step, which leaves each
    stream's first sample (the first of its block) as the whole run has
    it; the CLI prints its FPS line at two streams."""
    mcfg, _, model = weights
    port, _ = _datasets(cfg, 'val')
    predict = make_predict_fn_generic(model, 'bevformer')
    full = run_streaming_inference_batched(predict, model, port,
                                           _bev_shape(mcfg), 2)
    timer = bench_cli.StageTimer(torch.device('cpu'), warmup=0, samples=1)
    first = run_streaming_inference_batched(predict, model, port,
                                            _bev_shape(mcfg), 2, timer)
    per = -(-len(port) // 2)
    assert [i for i, r in enumerate(first) if r is not None] == [0, per]
    for i in (0, per):
        for k in ('boxes', 'scores', 'labels', 'valid'):
            assert np.array_equal(first[i][k], full[i][k])
    assert (timer.n_done, timer.n_batches, timer.seen) == (2, 1, 1)
    assert set(timer.totals) == set(bench_cli.STAGES)
    result = bench_cli.main([SYNTH_CFG, '--checkpoint', checkpoint,
                             '--samples', '3', '--warmup', '1',
                             '--device', 'cpu', '--cfg-options',
                             *cfg_options(dataroot),
                             'data.samples_per_device=2'])
    assert capsys.readouterr().out.startswith('Overall fps: ')
    assert result['samples'] == 4 and result['batch'] == 2
    assert result['fps'] > 0 and result['decode'] == 'host'
