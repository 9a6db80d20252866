"""The port's detection eval against the JAX package's, on the synthetic
dataset (``tests/conftest.py:synthetic_dataroot``):

* one results JSON (the val GT, jittered, rescored, with misses and false
  positives) through both ``DetectionEval``s gives equal metric dicts and
  equal per-(class, distance) metric data;
* the port's fake result (the GT as predictions) scores mAP 1.0 / NOS
  1.0, and the CLI ``_main`` with ``--render_curves 0`` writes the same
  summary;
* ``NewScenesDetDataset.format_results`` writes the same submission as
  JAX's from the same padded detections, and ``evaluate`` returns the same
  metrics.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from omnihd_scenes_tpu.data.dataset import (
    NewScenesDetDataset as JaxDataset)
from omnihd_scenes_tpu.devkit.converter import (
    create_newscenes_infos as jax_create_infos)
from omnihd_scenes_tpu.devkit.database import NewScenes as JaxNewScenes
from omnihd_scenes_tpu.eval.detection.config import (
    config_factory as jax_config_factory)
from omnihd_scenes_tpu.eval.detection.evaluate import (
    DetectionEval as JaxDetectionEval)
from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.devkit.fake_result import (create_fake_result,
                                                        write_fake_result)
from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
from omnihd_scenes_tpu_torch.eval.detection.evaluate import DetectionEval

CONFIG = 'detection_newsc_config_final'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def noisy_results(db, seed=0):
    """The val split's GT as a submission, each box moved up to 1.5 m,
    resized, turned, given a random score; a fifth dropped; one false
    positive per sample."""
    rng = np.random.RandomState(seed)
    sub = create_fake_result(db, 'val_mini')
    for token, annos in sub['results'].items():
        kept = []
        for a in annos:
            if rng.uniform() < 0.2:
                continue
            a = dict(a)
            a['translation'] = list(np.asarray(a['translation'])
                                    + rng.uniform(-1.5, 1.5, 3))
            a['size'] = list(np.asarray(a['size'])
                             * rng.uniform(0.8, 1.2, 3))
            a['velocity'] = list(np.asarray(a['velocity'])
                                 + rng.uniform(-1, 1, 2))
            a['detection_score'] = float(rng.uniform(0.05, 1.0))
            kept.append(a)
        if annos:
            fp = dict(annos[0])
            fp['translation'] = [float(v) for v in rng.uniform(-20, 20, 3)]
            fp['detection_score'] = float(rng.uniform(0.05, 1.0))
            kept.append(fp)
        sub['results'][token] = [
            {k: ([float(x) for x in v] if isinstance(v, list) else v)
             for k, v in a.items()} for a in kept]
    return sub


def _eval(cls, db, cfg, path, out):
    ev = cls(db, config=cfg, result_path=path, eval_set='val_mini',
             output_dir=out, verbose=False)
    metrics, md = ev.evaluate()
    summary = metrics.serialize()
    summary.pop('eval_time')
    return summary, md.serialize()


@pytest.fixture(scope='module')
def dbs(synthetic_dataroot):
    return (JaxNewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                         verbose=False),
            NewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                      verbose=False))


def test_same_metrics_on_one_results_file(dbs, tmp_path):
    jax_db, db = dbs
    path = str(tmp_path / 'results.json')
    with open(path, 'w') as f:
        json.dump(noisy_results(db), f)
    want, want_md = _eval(JaxDetectionEval, jax_db,
                          jax_config_factory(CONFIG), path,
                          str(tmp_path / 'jax'))
    got, got_md = _eval(DetectionEval, db, config_factory(CONFIG), path,
                        str(tmp_path / 'port'))
    assert got == want
    assert got_md == want_md
    assert 0.05 < want['mean_ap'] < 0.95          # neither trivial end


def test_fake_result_scores_one(dbs, tmp_path):
    _, db = dbs
    path = write_fake_result(db, str(tmp_path / 'fake.json'))
    got, _ = _eval(DetectionEval, db, config_factory(CONFIG), path,
                   str(tmp_path / 'out'))
    assert got['mean_ap'] == pytest.approx(1.0, abs=1e-9)
    assert got['NOS'] == pytest.approx(1.0, abs=1e-9)


def test_cli_without_curves(dbs, synthetic_dataroot, tmp_path):
    _, db = dbs
    path = write_fake_result(db, str(tmp_path / 'fake.json'))
    out = tmp_path / 'metrics'
    proc = subprocess.run(
        [sys.executable, '-m', 'omnihd_scenes_tpu_torch.eval.detection.'
         'evaluate', path, '--dataroot', synthetic_dataroot, '--version',
         'v1.0-mini', '--eval_set', 'val_mini', '--output_dir', str(out),
         '--verbose', '0', '--render_curves', '0'],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads((out / 'metrics_summary.json').read_text())
    assert summary['mean_ap'] == pytest.approx(1.0, abs=1e-9)
    assert 'NOS: 1.0000' in proc.stdout


def test_curve_rendering_is_refused(dbs, tmp_path, monkeypatch):
    """Without matplotlib, rendering the curves (the default) raises an
    ImportError that names the switch that evaluates without them."""
    _, db = dbs
    path = write_fake_result(db, str(tmp_path / 'fake.json'))
    ev = DetectionEval(db, config=config_factory(CONFIG), result_path=path,
                       eval_set='val_mini', output_dir=str(tmp_path / 'o'),
                       verbose=False)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='render_curves 0'):
        ev.main()


@pytest.fixture(scope='module')
def val_datasets(synthetic_dataroot, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('eval_infos'))
    jax_create_infos(synthetic_dataroot, out, 'synth', version='v1.0-mini',
                     max_sweeps=0)
    ann = os.path.join(out, 'synth_infos_temporal_val.pkl')
    kw = dict(ann_file=ann, modality='radar', max_points=100, test_mode=True)
    return JaxDataset(**kw), NewScenesDetDataset(**kw)


def padded_detections(n, seed=1, k=12):
    """Per-sample padded (boxes, scores, labels, valid) like the
    predictors return."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        boxes = rng.uniform(-30, 30, (k, 9)).astype(np.float32)
        boxes[:, 3:6] = rng.uniform(0.5, 5, (k, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, k)
        out.append({'boxes': boxes,
                    'scores': rng.uniform(0, 1, k).astype(np.float32),
                    'labels': rng.randint(0, 4, k).astype(np.int32),
                    'valid': rng.uniform(size=k) < 0.8})
    return out


def test_format_results_and_evaluate_match(val_datasets, synthetic_dataroot,
                                           tmp_path):
    jax_ds, ds = val_datasets
    dets = padded_detections(len(ds))
    paths = [d.format_results(dets, str(tmp_path / name))
             for d, name in ((jax_ds, 'jax'), (ds, 'port'))]
    with open(paths[0]) as f, open(paths[1]) as g:
        assert json.load(g) == json.load(f)
    kw = dict(dataroot=synthetic_dataroot, version='v1.0-mini',
              eval_set='val_mini')
    want = jax_ds.evaluate(dets, jsonfile_prefix=str(tmp_path / 'je'), **kw)
    got = ds.evaluate(dets, jsonfile_prefix=str(tmp_path / 'pe'), **kw)
    assert got == want
    assert set(got) >= {'mAP', 'NOS', 'AP_car'}


def test_infos_of_the_shared_dataroot_load(val_datasets):
    """The eval's dataset reads the JAX converter's infos (the same
    pickle layout)."""
    jax_ds, ds = val_datasets
    assert len(ds) == len(jax_ds) > 0
    assert [i['token'] for i in ds.infos] == [i['token']
                                              for i in jax_ds.infos]
    assert pickle.dumps(ds.classes) == pickle.dumps(jax_ds.classes)
