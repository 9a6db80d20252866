"""The port's config system and CLIs.

* ``train/config.py:Config`` reads every file of ``configs/`` and
  ``configs/synthetic/`` (``_base_`` chains included) into the same dict
  as the JAX package's, and ``merge_from_options`` / ``dump`` agree;
* ``build_model_from_cfg`` builds the pillar families, the camera-only
  and the fusion models (BEVFusion, RCFusion, BEVFusion-OCC) and
  BEVFormer-T, R50 and R101-DCN, from the shipped configs; R101-DCN's
  backbone serves a frame (``tests/test_torch_port_temporal.py`` runs the
  BEVFormer eval);
* ``tools.train configs/synthetic/bevformer_synth.py`` trains BEVFormer-T
  on a dataroot with images (frame queues, the Hungarian-matched loss, no
  periodic eval) and ``tools.test --eval`` streams the val split from its
  checkpoint;
* ``tools.train`` then ``tools.test --eval`` run end to end with
  ``--device cpu`` on ``configs/synthetic/pointpillars_radar_synth.py``
  over a synthetic dataroot written without images: checkpoints, the JSON
  log, finite metrics; ``--resume-from`` picks up the step count;
  ``--bad-conditions`` evaluates the rainy / night scenes;
* the same on ``configs/synthetic/bevfusion_synth.py`` (BEVFusion-OCC:
  cameras, radar, occupancy GT) over a dataroot with images: falling
  occupancy losses, finite ``occ_IoU`` / ``occ_mIoU``, the val record
  equal to the test CLI's metrics;
* ``tools.train`` with ``aug``, ``data.workers_per_device=2`` and
  ``load_pts_from``, and ``--resume-from`` taking precedence over it;
* ``--int8`` and ``--host-nms`` are refused (``--host-nms`` is ignored
  for BEVFormer, whose decode is NMS-free), and a CUDA device that is not
  there is an error, not a silent fallback.
"""

import dataclasses
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.train.config import Config as JaxConfig
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)
from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
from omnihd_scenes_tpu_torch.models.bevfusion import (BEVFusion,
                                                      CrossModalFusion)
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL
from omnihd_scenes_tpu_torch.tools import test as test_cli
from omnihd_scenes_tpu_torch.tools import train as train_cli
from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
from omnihd_scenes_tpu_torch.train.config import Config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in
                 list((ROOT / 'configs').glob('*.py'))
                 + list((ROOT / 'configs' / 'synthetic').glob('*.py')))
SYNTH = str(ROOT / 'configs/synthetic/pointpillars_radar_synth.py')
MTL_SYNTH = str(ROOT / 'configs/synthetic/bevfusion_synth.py')
BUILT = {'configs/pointpillars_radar.py': ('pointpillars', 13),
         'configs/radarpillarnet.py': ('radarpillarnet', 17),
         'configs/pointpillars_lidar.py': ('pointpillars', 9),
         'configs/synthetic/pointpillars_radar_synth.py': ('pointpillars',
                                                           13)}
FUSION = {'configs/rcfusion.py': ('rcfusion', BEVFusion),
          'configs/bevfusion_occ.py': ('bevfusion_mtl', BEVFusionMTL),
          'configs/synthetic/bevfusion_synth.py': ('bevfusion_mtl',
                                                   BEVFusionMTL)}
# BEVFormer-T: (BEV, embed dims, queries, encoder / decoder layers,
# cameras, image, ResNet depth).
BEVFORMER = {'configs/bevformer_t_r50.py': ((160, 240), 256, 900, (3, 6), 6,
                                            (544, 960), 50),
             'configs/bevformer_t_r101.py': ((160, 240), 256, 900, (3, 6), 6,
                                             (864, 1536), 101),
             'configs/synthetic/bevformer_synth.py': ((16, 24), 64, 32, (1, 2),
                                                      6, (128, 192), 18)}
# R101-DCN, refused until DCNv2 was ported: its ``stage_with_dcn``.
DCN_CONFIGS = {'configs/bevformer_t_r101.py': (False, False, True, True)}
BEVFORMER_SYNTH = str(ROOT / 'configs/synthetic/bevformer_synth.py')


def test_every_config_is_listed():
    assert len(CONFIGS) == 12
    assert set(BUILT) | set(FUSION) | set(BEVFORMER) | set(DCN_CONFIGS) | {
        'configs/bevfusion.py', 'configs/lss_camera.py'} == set(CONFIGS)


@pytest.mark.parametrize('path', CONFIGS)
def test_config_equals_jax(path, tmp_path):
    opts = ['model.num_classes=4', 'data.samples_per_device=3',
            'new.key="x"', 'work_dir=/w']
    want, got = JaxConfig.fromfile(str(ROOT / path)), Config.fromfile(
        str(ROOT / path))
    assert got.to_dict() == want.to_dict()
    want.merge_from_options(opts)
    got.merge_from_options(opts)
    assert got.to_dict() == want.to_dict()
    want.dump(str(tmp_path / 'jax.py'))
    got.dump(str(tmp_path / 'port.py'))
    assert (tmp_path / 'port.py').read_text() == (
        tmp_path / 'jax.py').read_text()


@pytest.mark.parametrize('path', sorted(BUILT))
def test_pillar_configs_build(path):
    model, mtype = build_model_from_cfg(Config.fromfile(str(ROOT / path)))
    want_type, pfn_in = BUILT[path]
    assert isinstance(model, PointPillars) and mtype == want_type
    assert model.pillar_encoder.pfn[0].linear.in_features == pfn_in
    assert model.cfg.with_velocity_snr_center == (mtype == 'radarpillarnet')


def test_full_width_pillar_configs():
    """The shipped pillar configurations at full width: 320x480 at 0.25 m,
    30,000 pillars, SECOND 64/128/256, FPN 3x128, 307,200 anchors."""
    for path in ('configs/pointpillars_radar.py', 'configs/radarpillarnet.py',
                 'configs/pointpillars_lidar.py'):
        model, _ = build_model_from_cfg(Config.fromfile(str(ROOT / path)))
        cfg = model.cfg
        assert cfg.bev_hw == (320, 480) and cfg.max_voxels == 30000
        assert cfg.second_channels == (64, 128, 256)
        assert cfg.fpn_channels == (128, 128, 128)
        assert cfg.anchors().reshape(-1, 9).shape[0] == 307200
        assert cfg.max_points_per_voxel == (64 if 'lidar' in path else 10)


def test_fusion_and_camera_configs_build():
    model, mtype = build_model_from_cfg(Config.fromfile(
        str(ROOT / 'configs/bevfusion.py')))
    assert isinstance(model, BEVFusion) and mtype == 'bevfusion'
    assert model.fuse is not None and model.se is not None
    model, mtype = build_model_from_cfg(Config.fromfile(
        str(ROOT / 'configs/lss_camera.py')))
    assert mtype == 'lss' and model.fuse is None


@pytest.mark.parametrize('path', sorted(FUSION))
def test_rcfusion_and_mtl_configs_build(path):
    """RCFusion and BEVFusion-OCC, refused before their port, build with
    their fuser and heads."""
    model, mtype = build_model_from_cfg(Config.fromfile(str(ROOT / path)))
    want_type, cls = FUSION[path]
    assert mtype == want_type and isinstance(model, cls)
    if mtype == 'rcfusion':
        assert isinstance(model.fuse, CrossModalFusion)
    else:
        assert model.occ_head.fc2.out_features == 12 * 16
        assert isinstance(model.fusion.fuse, torch.nn.Module)


@pytest.mark.parametrize('path', sorted(BEVFORMER))
def test_bevformer_configs_build(path):
    """BEVFormer-T, refused before its port, builds at the config's widths:
    ResNet (frozen BN, stage 3 out) + a one-level FPN + the temporal
    head."""
    model, mtype = build_model_from_cfg(Config.fromfile(str(ROOT / path)))
    assert mtype == 'bevformer' and isinstance(model, BEVFormerDetector)
    bev, dims, queries, (n_enc, n_dec), cams, img_hw, depth = BEVFORMER[path]
    cfg = model.cfg
    assert ((cfg.bev_h, cfg.bev_w), cfg.embed_dims, cfg.num_query,
            cfg.num_cams, cfg.img_hw, cfg.resnet_depth) == (
        bev, dims, queries, cams, img_hw, depth)
    head = model.pts_bbox_head
    assert head.bev_embedding.shape == (bev[0] * bev[1], dims)
    assert len(head.transformer.encoder.layers) == n_enc
    assert len(head.transformer.decoder.layers) == n_dec
    assert model.img_neck.lateral_convs[0].in_channels == (
        512 if depth == 18 else 2048)
    assert cfg.sca_query_cap == 1.0 and cfg.tsa_impl == 'gather'


@pytest.mark.parametrize('path', sorted(DCN_CONFIGS))
def test_unported_families_are_refused(path):
    """Named for the refusal it pinned until DCNv2 was ported.  R101-DCN
    builds: ResNet-101 with a ``DeformConv`` as the 3x3 conv of every
    block of the stages its ``stage_with_dcn`` marks (23 + 3), and serves
    one frame through ``StreamPredictor`` on the CPU with that backbone
    (the head cut to a test's size, the image to 64x96)."""
    from omnihd_scenes_tpu_torch.models.dcn import DeformConv
    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_stream_frame)

    model, mtype = build_model_from_cfg(Config.fromfile(str(ROOT / path)))
    cfg = model.cfg
    assert mtype == 'bevformer' and cfg.stage_with_dcn == DCN_CONFIGS[path]
    for s, dcn in enumerate(cfg.stage_with_dcn):
        layer = getattr(model.img_backbone, f'layer{s + 1}')
        assert all(isinstance(b.conv2, DeformConv) == dcn for b in layer)
    assert len(model.img_backbone.layer3) == 23
    small = dataclasses.replace(cfg, bev_h=8, bev_w=12, num_query=16,
                                embed_dims=32, encoder_layers=1,
                                decoder_layers=1, num_cams=2,
                                img_hw=(64, 96))
    predictor = StreamPredictor(small, random_bevformer_state_dict(small, 1),
                                device='cpu', dtype=torch.float32)
    frame = random_stream_frame(np.random.RandomState(0), small, 1)
    (boxes, scores, _, _), bev = predictor(*frame, predictor.zero_bev(1),
                                           np.array([False]))
    assert boxes.shape == (1, 300, 9) and bool(torch.isfinite(boxes).all())
    assert bool(torch.isfinite(bev).all()) and bev.shape == (1, 96, 32)


def test_bevformer_training_is_refused(image_dataroot, tmp_path):
    """Named for the refusal it pinned until its port.  BEVFormer-T
    training runs: ``tools.train`` takes its steps on the temporal
    dataset's frame queues (finite losses, no periodic eval, as in the JAX
    package), writes a checkpoint, and ``tools.test --eval`` streams the
    val split from it."""
    work = str(tmp_path / 'work')
    state = train_cli.main([BEVFORMER_SYNTH, '--work-dir', work, '--device',
                            'cpu', '--cfg-options',
                            *cfg_options(image_dataroot)])
    records = [json.loads(line) for line in
               open(os.path.join(work, 'train.log.json'))]
    train = [r for r in records if r['mode'] == 'train']
    assert len(train) == state.step == 6
    for key in ('loss', 'loss_cls', 'loss_bbox', 'grad_norm'):
        assert all(math.isfinite(r[key]) for r in train), key
    assert not [r for r in records if r['mode'] == 'val']
    assert os.listdir(os.path.join(work, 'ckpts')) == ['ckpt_1.pt']
    out = str(tmp_path / 'test')
    metrics = test_cli.main([BEVFORMER_SYNTH, os.path.join(work, 'ckpts'),
                             '--eval', '--out-dir', out, '--device', 'cpu',
                             '--cfg-options', *cfg_options(image_dataroot)])
    assert math.isfinite(metrics['mAP']) and math.isfinite(metrics['NOS'])
    assert json.load(open(os.path.join(out, 'metrics.json'))) == metrics


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cli_synth'))
    generate(root, 'v1.0-mini', SyntheticConfig(), images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def cfg_options(root):
    return [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']


@pytest.fixture(scope='module')
def trained(dataroot, tmp_path_factory):
    work = str(tmp_path_factory.mktemp('cli_work'))
    state = train_cli.main([SYNTH, '--work-dir', work, '--device', 'cpu',
                            '--cfg-options', *cfg_options(dataroot)])
    return work, state


def test_train_cli_writes_checkpoints_and_log(trained):
    work, state = trained
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == ['ckpt_2.pt']
    records = [json.loads(line) for line in
               open(os.path.join(work, 'train.log.json'))]
    modes = [r['mode'] for r in records]
    assert modes[0] == 'env' and modes[-1] == 'done'
    assert records[0]['device'] == 'cpu'
    train = [r for r in records if r['mode'] == 'train']
    assert len(train) == 6 and all(math.isfinite(r['loss']) for r in train)
    assert train[-1]['loss'] < train[0]['loss']
    val = [r for r in records if r['mode'] == 'val']
    assert len(val) == 1 and math.isfinite(val[0]['NOS'])
    assert records[-1]['final_step'] == state.step == 6
    assert os.path.exists(os.path.join(work, 'config.py'))


def test_test_cli_evaluates(trained, dataroot, tmp_path):
    work, _ = trained
    out = str(tmp_path / 'test')
    metrics = test_cli.main([SYNTH, os.path.join(work, 'ckpts'), '--eval',
                             '--out-dir', out, '--device', 'cpu',
                             '--cfg-options', *cfg_options(dataroot)])
    assert math.isfinite(metrics['mAP']) and math.isfinite(metrics['NOS'])
    assert json.load(open(os.path.join(out, 'metrics.json'))) == metrics
    # The same checkpoint's eval inside training saw the same weights.
    val = [json.loads(line) for line in
           open(os.path.join(work, 'train.log.json'))
           if '"val"' in line][0]
    assert val['mAP'] == pytest.approx(metrics['mAP'], abs=1e-12)


def test_test_cli_format_only(trained, dataroot, tmp_path):
    work, _ = trained
    out = str(tmp_path / 'fmt')
    test_cli.main([SYNTH, os.path.join(work, 'ckpts', 'ckpt_2.pt'),
                   '--format-only', '--out-dir', out, '--device', 'cpu',
                   '--cfg-options', *cfg_options(dataroot)])
    sub = json.load(open(os.path.join(out, 'results_newsc.json')))
    assert sub['meta']['use_radar'] and len(sub['results']) > 0


def test_resume(trained, dataroot, tmp_path):
    work, _ = trained
    state = train_cli.main([
        SYNTH, '--work-dir', str(tmp_path), '--device', 'cpu',
        '--no-validate', '--resume-from', os.path.join(work, 'ckpts'),
        '--cfg-options', 'total_epochs=1', *cfg_options(dataroot)])
    assert state.step == 6 + 3
    records = [json.loads(line) for line in
               open(tmp_path / 'train.log.json')]
    assert {'mode': 'resume', 'step': 6} in records


def test_train_cli_aug_workers_and_load_pts_from(trained, dataroot,
                                                 tmp_path):
    """``tools.train`` with the points' ``rot_scale_flip``, two spawn
    workers and ``load_pts_from`` the trained checkpoints: every parameter
    loads, the losses are finite, the log says so; ``--resume-from``
    takes precedence over the staged load, as in the JAX package."""
    work, _ = trained
    ckpts = os.path.join(work, 'ckpts')
    opts = ['total_epochs=1', 'data.workers_per_device=2',
            "data.train.aug={'rot_scale_flip': {}}",
            f'load_pts_from={ckpts}', *cfg_options(dataroot)]
    state = train_cli.main([SYNTH, '--work-dir', str(tmp_path / 'staged'),
                            '--device', 'cpu', '--no-validate',
                            '--cfg-options', *opts])
    records = [json.loads(line) for line in
               open(tmp_path / 'staged' / 'train.log.json')]
    n_params = len(list(state.model.parameters()))
    assert [r for r in records if r['mode'] == 'load_pts_from'] == [
        {'mode': 'load_pts_from', 'loaded': n_params}]
    train = [r for r in records if r['mode'] == 'train']
    assert len(train) == 3 and all(math.isfinite(r['loss']) for r in train)
    assert records[-1]['mode'] == 'done'

    state = train_cli.main([SYNTH, '--work-dir', str(tmp_path / 'resumed'),
                            '--device', 'cpu', '--no-validate',
                            '--resume-from', ckpts, '--cfg-options', *opts])
    records = [json.loads(line) for line in
               open(tmp_path / 'resumed' / 'train.log.json')]
    assert {'mode': 'resume', 'step': 6} in records
    assert not [r for r in records if r['mode'] == 'load_pts_from']
    assert state.step == 6 + 3


@pytest.mark.parametrize('flag', ['--int8', '--host-nms'])
def test_unported_test_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit):
        test_cli.parse_args([SYNTH, 'ckpt', '--eval', flag])
    assert 'not ported yet' in capsys.readouterr().err


def test_bad_conditions_flag_evaluates(trained, dataroot, tmp_path):
    """``--bad-conditions``, refused before its port: the detection eval
    of the rainy / night val scenes (all of the synthetic val split)."""
    work, _ = trained
    assert test_cli.parse_args([SYNTH, 'ckpt', '--bad-conditions']
                               ).bad_conditions
    metrics = test_cli.main([SYNTH, os.path.join(work, 'ckpts'), '--eval',
                             '--bad-conditions', '--out-dir',
                             str(tmp_path), '--device', 'cpu',
                             '--cfg-options', *cfg_options(dataroot)])
    assert math.isfinite(metrics['mAP']) and math.isfinite(metrics['NOS'])


@pytest.fixture(scope='module')
def image_dataroot(tmp_path_factory):
    """A synthetic dataroot with camera JPEGs (the port's generator, which
    needs OpenCV for them) and its infos."""
    pytest.importorskip('cv2')
    root = str(tmp_path_factory.mktemp('cli_synth_images'))
    generate(root, 'v1.0-mini', SyntheticConfig(), images=True)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def test_camera_dataset_is_refused(image_dataroot, tmp_path):
    """The camera configs, refused before the camera data path was
    ported, load: ``configs/lss_camera.py``'s dataset (``modality=
    'camera'``; its depth GT off, the synthetic dataroot has none) reads
    the synthetic JPEGs at the model's 544x960."""
    from omnihd_scenes_tpu_torch.train.detection import build_datasets

    cfg = Config.fromfile(str(ROOT / 'configs/lss_camera.py'))
    cfg.merge_from_options(cfg_options(image_dataroot)
                           + ['data.train.load_depth_gt=False'])
    train_ds, _ = build_datasets(cfg)
    sample = train_ds[0]
    assert sample['imgs'].shape == (6, 544, 960, 3)
    assert 'points' not in sample and 'gt_boxes' in sample


@pytest.fixture(scope='module')
def mtl_trained(image_dataroot, tmp_path_factory):
    work = str(tmp_path_factory.mktemp('cli_mtl_work'))
    state = train_cli.main([MTL_SYNTH, '--work-dir', work, '--device', 'cpu',
                            '--cfg-options', 'eval_interval=1',
                            *cfg_options(image_dataroot)])
    return work, state


def test_mtl_train_cli_logs_occupancy(mtl_trained):
    work, state = mtl_trained
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == ['ckpt_1.pt']
    records = [json.loads(line) for line in
               open(os.path.join(work, 'train.log.json'))]
    train = [r for r in records if r['mode'] == 'train']
    assert len(train) == 6 and state.step == 6
    for key in ('loss', 'loss_occ', 'loss_ssc', 'loss_cls'):
        assert all(math.isfinite(r[key]) for r in train), key
    for key in ('loss', 'loss_occ', 'loss_ssc'):
        assert train[-1][key] < train[0][key], key
    val = [r for r in records if r['mode'] == 'val']
    assert len(val) == 1
    assert math.isfinite(val[0]['occ_IoU'])
    assert math.isfinite(val[0]['occ_mIoU'])


def test_mtl_test_cli_evaluates_occupancy(mtl_trained, image_dataroot,
                                          tmp_path):
    work, _ = mtl_trained
    out = str(tmp_path / 'test')
    metrics = test_cli.main([MTL_SYNTH, os.path.join(work, 'ckpts'),
                             '--eval', '--out-dir', out, '--device', 'cpu',
                             '--cfg-options', *cfg_options(image_dataroot)])
    assert json.load(open(os.path.join(out, 'metrics.json'))) == metrics
    assert math.isfinite(metrics['occ_IoU'])
    assert math.isfinite(metrics['occ_mIoU'])
    assert {f'occ_cls_{i}' for i in range(1, 12)} <= set(metrics)
    val = [json.loads(line) for line in
           open(os.path.join(work, 'train.log.json'))
           if '"val"' in line][0]
    for key in ('mAP', 'NOS', 'occ_IoU', 'occ_mIoU'):
        assert val[key] == pytest.approx(metrics[key], abs=1e-12), key


def test_cuda_is_the_default_device(monkeypatch):
    assert train_cli.parse_args([SYNTH]).device == 'cuda'
    assert test_cli.parse_args([SYNTH, 'ckpt']).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        train_cli.resolve_device('cuda')
