"""The comparison that decides ``correct`` has to fail: each cell's
control (its reference one precision step below the configuration's, in
the program's place), and a run whose timed path is broken underneath,
once for each fault the cell can have.  At a mini width on the CPU; the
limits are the cells' own (``perfbench/limits/<cell>.json``)."""

import time

import pytest
import torch

from perfbench import control, harness, lowp, manifest
from perfbench.tests import minis

CPU = torch.device('cpu')
SEED = 2 ** 41 + 17


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return minis.mini_root(tmp_path_factory.mktemp('bench'))


def _run(root, cell):
    return harness.run_cell(manifest.load_cell(cell, root), SEED, 0.6, False,
                            CPU, time.perf_counter())


@pytest.mark.parametrize('cell', sorted(minis.MINI_CELLS))
def test_sound_run_is_correct(root, cell):
    line = _run(root, f'{cell}_mini')
    assert line['correct'], line['checks']


@pytest.mark.parametrize('cell', sorted(minis.MINI_CELLS))
def test_control_fails_a_limit(root, cell):
    c = manifest.load_cell(f'{cell}_mini', root)
    numbers = dict(control.readings(c, SEED, 0.6, CPU, True))
    kind = next(k for k in numbers if k != 'program')
    assert all(v <= c.limits[k]['limit']
               for k, v in numbers['program'].items())
    assert any(v > c.limits[k]['limit'] for k, v in numbers[kind].items()), \
        numbers


def _half_batch(cls, method):
    """``cls.method`` on the first half of the batch, its outputs tiled
    over the whole: half of the batch left out."""
    orig = getattr(cls, method)

    def half(self, *args):
        b = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
        part = [a[:max(b // 2, 1)] if isinstance(a, torch.Tensor) else a
                for a in args]
        out = orig(self, *part)
        return _tile({k: v for k, v in out.items() if v is not None}, b)
    return half


def _tile(out, b):
    return {k: v.repeat(b // v.shape[0] + 1, *[1] * (v.dim() - 1))[:b]
            for k, v in out.items()}


def _half_head(cls):
    """BEVFormer's head on the first half of the streams, its outputs
    tiled over all of them."""
    orig = cls.forward

    def half(self, mlvl_feats, can_bus, lidar2img, img_hw, prev_bev=None,
             has_prev=None):
        b = can_bus.shape[0]
        h, n = max(b // 2, 1), mlvl_feats[0].shape[0] // b
        return _tile(orig(self, [f[:h * n] for f in mlvl_feats],
                          can_bus[:h], lidar2img[:h], img_hw,
                          prev_bev=prev_bev[:h], has_prev=has_prev[:h]), b)
    return half


def _altered(fn):
    """``fn``'s detections with each sample's first served score moved:
    an answer altered where it is produced."""
    def alter(*args, **kw):
        boxes, scores, labels, valid = fn(*args, **kw)
        scores = scores.clone()
        scores[:, 0] += 0.25
        return boxes, scores, labels, valid
    return alter


def test_bevfusion_faults_fail(root, monkeypatch):
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve import predictor
    cell = 'bevfusion_serve_b4_mini'
    with monkeypatch.context() as m:
        m.setattr(BEVFusion, 'forward', _half_batch(BEVFusion, 'forward'))
        assert not _run(root, cell)['correct']
    with monkeypatch.context() as m:
        m.setattr(predictor, 'anchor_head_get_bboxes',
                  _altered(predictor.anchor_head_get_bboxes))
        line = _run(root, cell)
        assert not line['correct']
        assert line['checks']['decode_mismatch']['value'] > 0


def test_bevformer_faults_fail(root, monkeypatch):
    from omnihd_scenes_tpu_torch.models.bevformer.head import BEVFormerHead
    from omnihd_scenes_tpu_torch.serve import predictor
    cell = 'bevformer_r50_stream_b4_mini'

    def unchanged(self, imgs, can_bus, lidar2img, prev_bev, has_prev):
        dets, _ = predictor.predict_stream(self.model, imgs, can_bus,
                                           lidar2img, prev_bev, has_prev,
                                           self.coder_cfg)
        return dets, prev_bev
    with monkeypatch.context() as m:
        m.setattr(predictor.StreamPredictor, '__call__', unchanged)
        assert not _run(root, cell)['correct']
    with monkeypatch.context() as m:
        m.setattr(BEVFormerHead, 'forward', _half_head(BEVFormerHead))
        assert not _run(root, cell)['correct']
    with monkeypatch.context() as m:
        m.setattr(predictor, 'nms_free_decode',
                  _altered(predictor.nms_free_decode))
        line = _run(root, cell)
        assert not line['correct']
        assert line['checks']['decode_mismatch']['value'] > 0


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(10000)
    e8 = float((lowp.round_fp8(x) - x).abs().max() / x.abs().max())
    e16 = float((x.bfloat16().float() - x).abs().max() / x.abs().max())
    assert e8 > 4 * e16


def test_bevfusion_train_faults_fail(root, monkeypatch):
    from omnihd_scenes_tpu_torch.train import builder
    from omnihd_scenes_tpu_torch.train.optim import AdamW
    cell = 'bevfusion_train_b1_mini'

    def unchanged(self, grads):
        """A step that leaves the state as it was."""
        self.count += 1
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(grads))))
    with monkeypatch.context() as m:
        m.setattr(AdamW, 'step', unchanged)
        line = _run(root, cell)
        assert not line['correct']
        assert line['checks']['update_norm_gap']['value'] == pytest.approx(
            1.0)
    orig = builder.DetectionLosses.__call__

    def altered(self, out, batch):
        """The loss altered where it is produced."""
        total, aux = orig(self, out, batch)
        return total * 1.05, aux
    with monkeypatch.context() as m:
        m.setattr(builder.DetectionLosses, '__call__', altered)
        assert not _run(root, cell)['correct']
