"""The port's detection curve plots (``eval/detection/render.py`` and
``DetectionEval.render``) against the JAX package's, on the synthetic
dataset: the same PNG files, byte for byte, from one results file; the
evaluation CLI's and ``main``'s defaults equal JAX's (curves rendered);
without matplotlib, rendering raises an ImportError that names
``--render_curves 0``, and ``--render_curves 0`` still evaluates."""

import json
import os
import subprocess
import sys

import pytest

from omnihd_scenes_tpu.devkit.database import NewScenes as JaxNewScenes
from omnihd_scenes_tpu.eval.detection import evaluate as jax_evaluate
from omnihd_scenes_tpu.eval.detection.config import (
    config_factory as jax_config_factory)
from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.devkit.fake_result import write_fake_result
from omnihd_scenes_tpu_torch.eval.common import load_gt
from omnihd_scenes_tpu_torch.eval.detection import evaluate
from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
from omnihd_scenes_tpu_torch.eval.detection.data_classes import DetectionBox
from omnihd_scenes_tpu_torch.eval.detection.render import visualize_sample
from tests.test_torch_port_eval import noisy_results

CONFIG = 'detection_newsc_config_final'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def dbs(synthetic_dataroot):
    return (JaxNewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                         verbose=False),
            NewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                      verbose=False))


@pytest.fixture(scope='module')
def results_path(dbs, tmp_path_factory):
    path = tmp_path_factory.mktemp('render') / 'results.json'
    path.write_text(json.dumps(noisy_results(dbs[1])))
    return str(path)


def _plots(out):
    d = os.path.join(out, 'plots')
    return {name: open(os.path.join(d, name), 'rb').read()
            for name in sorted(os.listdir(d))}


def test_curve_files_equal_jax(dbs, results_path, tmp_path):
    jax_db, db = dbs
    outs = {}
    for tag, mod, ndb, cfg in (
            ('jax', jax_evaluate, jax_db, jax_config_factory(CONFIG)),
            ('port', evaluate, db, config_factory(CONFIG))):
        out = str(tmp_path / tag)
        mod.DetectionEval(ndb, config=cfg, result_path=results_path,
                          eval_set='val_mini', output_dir=out,
                          verbose=False).main()
        outs[tag] = _plots(out)
    assert list(outs['port']) == list(outs['jax'])
    cfg = config_factory(CONFIG)
    assert set(outs['port']) == (
        {'summary.png'}
        | {f'{c}_{k}.png' for c in cfg.class_names for k in ('pr', 'tp')}
        | {f'dist_pr_{d}.png' for d in cfg.dist_ths})
    for name, data in outs['port'].items():
        assert data == outs['jax'][name], name


class _Recorder:
    """Stands in for ``DetectionEval`` to catch what ``_main`` passes."""

    seen = {}

    def __init__(self, newsc, **kwargs):
        _Recorder.seen['init'] = kwargs

    def main(self, **kwargs):
        _Recorder.seen['main'] = kwargs


@pytest.mark.parametrize('mod', [evaluate, jax_evaluate],
                         ids=['port', 'jax'])
def test_cli_defaults(mod, synthetic_dataroot, monkeypatch):
    _Recorder.seen = {}
    monkeypatch.setattr(mod, 'DetectionEval', _Recorder)
    monkeypatch.setattr(sys, 'argv', [
        'evaluate', 'r.json', '--dataroot', synthetic_dataroot,
        '--version', 'v1.0-mini', '--verbose', '0'])
    mod._main()
    seen = _Recorder.seen
    assert seen['main'] == {'plot_examples': 0, 'render_curves': True}
    assert seen['init']['eval_set'] == 'val'


def test_main_defaults_equal_jax():
    import inspect

    for name in ('main', '__init__'):
        got = inspect.signature(getattr(evaluate.DetectionEval, name))
        want = inspect.signature(getattr(jax_evaluate.DetectionEval, name))
        assert {k: p.default for k, p in got.parameters.items()} == \
            {k: p.default for k, p in want.parameters.items()}
    assert inspect.signature(evaluate.DetectionEval.main).parameters[
        'render_curves'].default is True


BLOCKED = ('import runpy, sys\n'
           'sys.modules["matplotlib"] = None\n'
           'sys.argv = ["evaluate"] + sys.argv[1:]\n'
           'runpy.run_module("omnihd_scenes_tpu_torch.eval.detection.'
           'evaluate", run_name="__main__")\n')


@pytest.mark.parametrize('curves', ['default', '0'])
def test_cli_without_matplotlib(dbs, synthetic_dataroot, tmp_path, curves):
    path = write_fake_result(dbs[1], str(tmp_path / 'fake.json'))
    out = tmp_path / 'metrics'
    args = [path, '--dataroot', synthetic_dataroot, '--version', 'v1.0-mini',
            '--eval_set', 'val_mini', '--output_dir', str(out),
            '--verbose', '0']
    if curves == '0':
        args += ['--render_curves', '0']
    proc = subprocess.run([sys.executable, '-c', BLOCKED] + args,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    if curves == '0':
        assert proc.returncode == 0, proc.stderr
        summary = json.loads((out / 'metrics_summary.json').read_text())
        assert summary['mean_ap'] == pytest.approx(1.0, abs=1e-9)
    else:
        assert proc.returncode != 0
        assert 'ImportError' in proc.stderr
        assert '--render_curves 0' in proc.stderr


def test_curve_rendering_is_refused_before_evaluating(dbs, results_path,
                                                      tmp_path, monkeypatch):
    """Without matplotlib, ``main`` raises before it evaluates, so no
    finished evaluation is thrown away for want of the curves."""
    ev = evaluate.DetectionEval(dbs[1], config=config_factory(CONFIG),
                                result_path=results_path,
                                eval_set='val_mini',
                                output_dir=str(tmp_path), verbose=False)
    calls = []
    monkeypatch.setattr(ev, 'evaluate', lambda: calls.append(1))
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='--render_curves 0'):
        ev.main()
    assert calls == []


def test_visualize_sample_renders_png(dbs, tmp_path):
    db = dbs[1]
    gt = load_gt(db, 'val_mini', DetectionBox, verbose=False)
    token = gt.sample_tokens[0]
    out = tmp_path / 'sample.png'
    visualize_sample(db, token, gt, gt, savepath=str(out))
    assert out.stat().st_size > 1000
