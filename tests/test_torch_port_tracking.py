"""The port's tracking eval (``omnihd_scenes_tpu_torch/eval/tracking/``)
against the JAX package's: the cases of ``tests/test_tracking.py`` run
through both, with every metric equal within 1e-12 (NaN where JAX has
NaN), and ``TrackingEval`` on the synthetic dataset with the GT as the
submission and with identity switches, dropped tracks and false alarms.
Both packages' algorithms are NumPy in f64, so they agree to the bit."""

import json
import sys

import numpy as np
import pytest

from omnihd_scenes_tpu.devkit.database import NewScenes as JaxNewScenes
from omnihd_scenes_tpu.eval.tracking import algo as jax_algo
from omnihd_scenes_tpu.eval.tracking import data_classes as jax_dc
from omnihd_scenes_tpu.eval.tracking.evaluate import (
    TrackingEval as JaxTrackingEval)
from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.eval.tracking import (TrackingBox,
                                                   TrackingConfig,
                                                   TrackingEval)
from omnihd_scenes_tpu_torch.eval.tracking import algo
from omnihd_scenes_tpu_torch.eval.tracking import data_classes as dc
from omnihd_scenes_tpu_torch.eval.tracking.evaluate import load_tracking_gt
from omnihd_scenes_tpu_torch.eval.tracking.render import (
    CURVE_METRICS, render_tracking_curves)

TOL = 1e-12
PACKAGES = ((algo, dc), (jax_algo, jax_dc))


def same(got, want, tol=TOL):
    """Equal dicts / arrays / numbers, NaN where NaN, within ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            same(got[k], want[k], tol)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), (got, want)


def _box(mod, token, tid, xy, name='car', score=0.9):
    return mod.TrackingBox(sample_token=token,
                           translation=(xy[0], xy[1], 0.0),
                           size=(2, 4, 1.5), rotation=(1, 0, 0, 0),
                           ego_translation=(xy[0], xy[1], 0.0),
                           tracking_id=str(tid), tracking_name=name,
                           tracking_score=score)


def _frames(mod, n=6):
    """Two tracks moving along x."""
    gt, pred = [], []
    for t in range(n):
        gt.append([_box(mod, str(t), 'a', (t * 2.0, 0)),
                   _box(mod, str(t), 'b', (t * 2.0, 10))])
        pred.append([_box(mod, str(t), 'pa', (t * 2.0 + 0.1, 0)),
                     _box(mod, str(t), 'pb', (t * 2.0 + 0.1, 10))])
    return gt, pred


def _scene(mod, hit_pattern, extra_fp=0):
    """One GT track over len(hit_pattern) frames; a prediction on frames
    where hit_pattern[i] is truthy (+ far false alarms)."""
    gt, pred = [], []
    for t, hit in enumerate(hit_pattern):
        gt.append([_box(mod, str(t), 'g0', (t * 1.0, 0))])
        frame = []
        if hit:
            frame.append(_box(mod, str(t), 'p0', (t * 1.0 + 0.1, 0)))
        for k in range(extra_fp):
            frame.append(_box(mod, str(t), f'fp{k}', (50.0 + k, 30)))
        pred.append(frame)
    return gt, pred


def both(fn):
    """``fn(algo, data_classes)`` for the port and for JAX."""
    return [fn(a, d) for a, d in PACKAGES]


def test_perfect_tracking():
    got, want = both(lambda a, d: a.amota_amotp(*_frames(d), dist_th=2.0))
    same(got, want)
    assert got['amota'] > 0.95 and got['mota'] > 0.99
    assert got['amotp'] < 0.2


def _swapped(d):
    gt, pred = _frames(d)
    for t in range(3, len(pred)):          # two identity switches
        pred[t][0].tracking_id = 'pb'
        pred[t][1].tracking_id = 'pa'
    return gt, pred


def test_identity_switch_counted():
    got, want = both(lambda a, d: a.accumulate_class(
        [_swapped(d)[0]], [_swapped(d)[1]], 2.0, score_thr=0.0))
    same(got, want)
    assert got['ids'] == 2
    got, want = both(lambda a, d: a.amota_amotp(*_swapped(d), dist_th=2.0))
    same(got, want)
    perfect = algo.amota_amotp(*_frames(dc), dist_th=2.0)
    assert got['amota'] < perfect['amota'] and got['mota'] < perfect['mota']


def test_missing_track_lowers_recall():
    def run(a, d):
        gt, pred = _frames(d)
        pred = [[p for p in frame if p.tracking_id == 'pa']
                for frame in pred]
        return a.accumulate_class([gt], [pred], 2.0, score_thr=0.0)

    got, want = both(run)
    same(got, want)
    assert got['recall'] == pytest.approx(0.5)


def test_empty_predictions():
    got, want = both(lambda a, d: a.amota_amotp(
        _frames(d)[0], [[] for _ in range(6)], dist_th=2.0))
    same(got, want)
    assert got['amota'] == 0.0


def test_thresholds_interpolate_reference_convention():
    """np.interp of the (recall, score) curve: 3 GT, matched scores {0.9,
    0.6, 0.3} -> the threshold at recall 0.5 is 0.75; recalls above the
    achieved maximum are NaN."""
    def case(d, drop_last=False):
        gt, pred = [], []
        for t, score in enumerate((0.9, 0.6, 0.3)):
            gt.append([_box(d, str(t), 'a', (t * 50.0, 0))])
            pred.append([_box(d, str(t), 'pa', (t * 50.0, 0), score=score)])
        if drop_last:
            pred = pred[:2] + [[]]
        return [gt], [pred]

    for drop in (False, True):
        (thr, rec), (jthr, jrec) = both(lambda a, d: a.compute_thresholds(
            *case(d, drop), dist_th=2.0, nelem=10, min_recall=0.5))
        same(thr, jthr)
        same(rec, jrec)
        if not drop:
            assert rec[0] == pytest.approx(0.5)
            assert thr[0] == pytest.approx(0.75)
            assert thr[-1] == pytest.approx(0.3)
        else:
            assert np.isnan(thr[-1])


# (hit pattern, far false alarms a frame, scene times, scenes, expected)
SCENARIOS = {
    'late_init': ([0, 0, 1, 1, 1, 1, 1, 1, 1, 1], 0, None, 1,
                  {'tid': 1.0, 'lgd': 1.0, 'frag': 0, 'mt': 1, 'ml': 0}),
    'fragmentation': ([1, 1, 1, 0, 0, 1, 1, 0, 0, 1], 0, None, 1,
                      {'frag': 2, 'lgd': 1.0, 'tid': 0.0, 'mt': 0,
                       'ml': 0}),
    'mostly_lost': ([1] + [0] * 9, 0, None, 1, {'ml': 1, 'mt': 0}),
    'untracked': ([0] * 10, 0, None, 1, {'ml': 1}),
    'real_timestamps': ([0, 0, 1, 1, 0, 1], 0,
                        [[0.0, 0.4, 2.4, 2.9, 3.3, 3.8]], 1,
                        {'tid': 2.4, 'lgd': 2.4}),
    'uniform_timestamps': ([0, 0, 1, 1, 0, 1], 0,
                           [[0.5 * i for i in range(6)]], 1,
                           {'tid': 1.0, 'lgd': 1.0}),
    'false_alarms': ([1] * 10, 2, None, 1, {'fp': 20, 'faf': 200.0}),
    'scene_isolation': ([1] * 5, 0, None, 2, {'mt': 2, 'ids': 0}),
}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_scenario_table(name):
    """The hand-built timelines of ``tests/test_tracking.py``: MT / ML /
    FRAG / TID / LGD / FAF, real timestamps and scene isolation."""
    pattern, fps, times, n_scenes, expected = SCENARIOS[name]

    def run(a, d):
        gt, pred = _scene(d, pattern, fps)
        return a.accumulate_class([gt] * n_scenes, [pred] * n_scenes, 2.0,
                                  score_thr=0.0, scene_times=times)

    got, want = both(run)
    same(got, want)
    for k, v in expected.items():
        assert got[k] == pytest.approx(v), k
    if name == 'untracked':
        assert np.isnan(got['tid']) and np.isnan(got['lgd'])


def test_curve_and_summary():
    def run(a, d):
        gt, pred = _scene(d, [1, 1, 1, 0, 1, 1, 1, 1, 1, 1])
        md = a.accumulate_curve([gt], [pred], 2.0, nelem=10)
        return md, a.summarize_curve(md, 2.0)

    (md, summary), (jmd, jsummary) = both(run)
    same(md, jmd)
    same(summary, jsummary)
    assert set(md) == set(algo.MD_FIELDS)
    assert set(dc.TRACKING_METRICS) - {'motar'} <= set(summary) | {'gt'}


def test_render_artifacts(tmp_path):
    gt, pred = _scene(dc, [1] * 8)
    md = algo.accumulate_curve([gt], [pred], 2.0, nelem=5)
    render_tracking_curves({'car': md}, str(tmp_path))
    assert (tmp_path / 'plots' / 'summary.png').stat().st_size > 1000
    for m in CURVE_METRICS:
        assert (tmp_path / 'plots' / f'{m}.png').stat().st_size > 1000


@pytest.fixture(scope='module')
def dbs(synthetic_dataroot):
    return (JaxNewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                         verbose=False),
            NewScenes(version='v1.0-mini', dataroot=synthetic_dataroot,
                      verbose=False))


def submission(db, degrade: bool, seed=0):
    """The val split's GT tracks as a submission, score 1; with
    ``degrade``: every other sample's first two tracks swap ids (identity
    switches), each track is dropped on a fifth of its frames, scores are
    random, and a false alarm is added to every third sample."""
    rng = np.random.RandomState(seed)
    gt = load_tracking_gt(db, 'val_mini')
    results = {}
    for i, tok in enumerate(sorted(gt, key=int)):
        annos = [b.serialize() for b in gt[tok]]
        for a in annos:
            a['tracking_score'] = 1.0
        if degrade:
            if i % 2 and len(annos) >= 2:
                annos[0]['tracking_id'], annos[1]['tracking_id'] = (
                    annos[1]['tracking_id'], annos[0]['tracking_id'])
            annos = [a for a in annos if rng.uniform() >= 0.2]
            for a in annos:
                a['tracking_score'] = float(rng.uniform(0.1, 1.0))
                a['translation'] = [float(v) + float(rng.uniform(-0.5, 0.5))
                                    for v in a['translation']]
            if i % 3 == 0 and gt[tok]:
                fa = gt[tok][0].serialize()
                fa.update(tracking_id='false_alarm',
                          tracking_score=float(rng.uniform(0.1, 1.0)),
                          translation=[float(v) for v in
                                       rng.uniform(-30, 30, 2)] + [0.0])
                fa['ego_translation'] = fa['translation']
                annos.append(fa)
        results[tok] = annos
    return {'meta': {}, 'results': results}


@pytest.mark.parametrize('degrade', [False, True],
                         ids=['gt_as_prediction', 'switches_drops_alarms'])
def test_tracking_eval_matches_jax(dbs, tmp_path, degrade):
    jax_db, db = dbs
    path = tmp_path / 'sub.json'
    path.write_text(json.dumps(submission(db, degrade)))
    want = JaxTrackingEval(jax_db, jax_dc.TrackingConfig(), str(path),
                           'val_mini', output_dir=str(tmp_path / 'jax'),
                           verbose=False).main(render_curves=False)
    out = tmp_path / 'port'
    got = TrackingEval(db, TrackingConfig(), str(path), 'val_mini',
                       output_dir=str(out), verbose=False).main()
    same(got, want)
    assert json.loads((out / 'tracking_metrics.json').read_text()).keys() \
        == want.keys()
    for name in ('summary',) + CURVE_METRICS:
        assert (out / 'plots' / f'{name}.png').exists()
    if degrade:
        assert got['ids'] > 0 and got['fp'] > 0
        assert 0.0 < got['amota'] < 0.95
    else:
        assert got['amota'] > 0.95 and got['mota'] > 0.99


def test_curve_rendering_is_refused_before_evaluating(dbs, tmp_path,
                                                      monkeypatch):
    """Without matplotlib, ``main`` with an output directory raises
    before it evaluates; without curves it evaluates as before."""
    path = tmp_path / 'sub.json'
    path.write_text(json.dumps(submission(dbs[1], False)))
    ev = TrackingEval(dbs[1], TrackingConfig(), str(path), 'val_mini',
                      output_dir=str(tmp_path / 'out'), verbose=False)
    frames = ev._scene_frames
    calls = []
    monkeypatch.setattr(ev, '_scene_frames',
                        lambda: calls.append(1) or frames())
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='--render_curves 0'):
        ev.main()
    assert calls == []
    assert ev.main(render_curves=False)['amota'] > 0.95
    assert calls == [1]


def test_box_round_trip():
    box = _box(dc, '7', 't1', (3.0, -2.0), name='rider', score=0.4)
    again = TrackingBox.deserialize(json.loads(json.dumps(box.serialize())))
    assert again.serialize() == box.serialize()
    assert again.serialize() == jax_dc.TrackingBox.deserialize(
        box.serialize()).serialize()
