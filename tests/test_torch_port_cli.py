"""The port's config system and CLIs.

* ``train/config.py:Config`` reads every file of ``configs/`` and
  ``configs/synthetic/`` (``_base_`` chains included) into the same dict
  as the JAX package's, and ``merge_from_options`` / ``dump`` agree;
* ``build_model_from_cfg`` builds the pillar families, the camera-only
  and the fusion model from the shipped configs, and refuses the
  unported families by name;
* ``tools.train`` then ``tools.test --eval`` run end to end with
  ``--device cpu`` on ``configs/synthetic/pointpillars_radar_synth.py``
  over a synthetic dataroot written without images: checkpoints, the JSON
  log, finite metrics; ``--resume-from`` picks up the step count;
* the unported flags are refused, and a CUDA device that is not there is
  an error, not a silent fallback.
"""

import json
import math
import os
import pathlib

import pytest
import torch

from omnihd_scenes_tpu.train.config import Config as JaxConfig
from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
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
BUILT = {'configs/pointpillars_radar.py': ('pointpillars', 13),
         'configs/radarpillarnet.py': ('radarpillarnet', 17),
         'configs/pointpillars_lidar.py': ('pointpillars', 9),
         'configs/synthetic/pointpillars_radar_synth.py': ('pointpillars',
                                                           13)}
REFUSED = {'configs/rcfusion.py': 'RCFusion',
           'configs/bevfusion_occ.py': 'MTL-OCC',
           'configs/bevformer_t_r50.py': 'BEVFormer',
           'configs/bevformer_t_r101.py': 'BEVFormer',
           'configs/synthetic/bevfusion_synth.py': 'MTL-OCC',
           'configs/synthetic/bevformer_synth.py': 'BEVFormer'}


def test_every_config_is_listed():
    assert len(CONFIGS) == 12
    assert set(BUILT) | set(REFUSED) | {'configs/bevfusion.py',
                                        'configs/lss_camera.py'} == set(
        CONFIGS)


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


@pytest.mark.parametrize('path', sorted(REFUSED))
def test_unported_families_are_refused(path):
    with pytest.raises(NotImplementedError, match=REFUSED[path]):
        build_model_from_cfg(Config.fromfile(str(ROOT / path)))


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


@pytest.mark.parametrize('flag', ['--int8', '--host-nms',
                                  '--bad-conditions'])
def test_unported_test_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit):
        test_cli.parse_args([SYNTH, 'ckpt', '--eval', flag])
    assert 'not ported yet' in capsys.readouterr().err


def test_camera_dataset_is_refused(dataroot, tmp_path):
    with pytest.raises(NotImplementedError, match='not ported'):
        train_cli.main([str(ROOT / 'configs/lss_camera.py'), '--work-dir',
                        str(tmp_path), '--device', 'cpu', '--cfg-options',
                        *cfg_options(dataroot)])


def test_cuda_is_the_default_device(monkeypatch):
    assert train_cli.parse_args([SYNTH]).device == 'cuda'
    assert test_cli.parse_args([SYNTH, 'ckpt']).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        train_cli.resolve_device('cuda')
