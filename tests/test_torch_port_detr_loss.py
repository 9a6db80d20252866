"""BEVFormer's DETR loss (``models/bevformer/loss.py``) and GridMask
(``models/bevformer/detector.py``) on the port against the JAX package,
on the CPU:

* every key of ``bevformer_head_loss`` (per layer, the last layer's and
  the total) within 1e-5 of max(1, |ref|), sample by sample against JAX's
  per-sample loss: on random outputs with padded GTs, on perfect
  predictions (JAX's ``test_head_loss_perfect_predictions``) and with no
  valid GT;
* the query-0 write (ROADMAP queue 3 item 14): a real GT matched to query
  0 with padded slots after it leaves query 0 positive, with the
  background label and a zero target, in both packages;
* f64 gradients with respect to the scores and the boxes within 1e-6 of
  ``jax.grad`` under ``jax.enable_x64`` (the loss alone reaches no
  ``bilinear_sample``);
* GridMask bit-equal to JAX's on equal draws (JAX's draws replayed from
  its key), and the masked share JAX's ``test_masks_fraction`` asks for.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnihd_scenes_tpu.models.bbox_coder import (
    normalize_bbox as jax_normalize_bbox)
from omnihd_scenes_tpu.models.bevformer.detector import (
    grid_mask as jax_grid_mask)
from omnihd_scenes_tpu.models.bevformer.head import (
    bevformer_head_loss as jax_loss)
from omnihd_scenes_tpu_torch.models.bevformer import (DETRLossCfg,
                                                      GridMaskDraws,
                                                      bevformer_head_loss,
                                                      grid_mask,
                                                      grid_mask_draws)
from omnihd_scenes_tpu_torch.models.bevformer.loss import assign_targets
from omnihd_scenes_tpu_torch.models.hungarian import hungarian_match

torch.set_num_threads(1)
TOL = 1e-5
GRAD_TOL = 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x))


def outputs(rng, b=2, n_layers=3, nq=20, c=4, dtype=np.float32):
    cls = rng.randn(b, n_layers, nq, c).astype(dtype) * 2
    box = np.concatenate([rng.uniform(-8, 8, (b, n_layers, nq, 2)),
                          rng.uniform(-0.5, 1.5, (b, n_layers, nq, 2)),
                          rng.uniform(-2, 2, (b, n_layers, nq, 1)),
                          rng.uniform(-0.5, 1, (b, n_layers, nq, 1)),
                          rng.uniform(-1, 1, (b, n_layers, nq, 4))],
                         -1).astype(dtype)
    return cls, box


def gts(rng, b=2, g=8, n_valid=(5, 3), dtype=np.float32):
    boxes = np.zeros((b, g, 9), dtype)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        boxes[i, :n, :3] = rng.uniform(-8, 8, (n, 3))
        boxes[i, :n, 3:6] = rng.uniform(0.5, 4, (n, 3))
        boxes[i, :n, 6:] = rng.uniform(-3, 3, (n, 3))
        labels[i, :n] = rng.randint(0, 4, n)
        mask[i, :n] = True
    return boxes, labels, mask


def assert_losses_equal_jax(cls, box, boxes, labels, mask):
    got = bevformer_head_loss(*map(t, (cls, box, boxes, labels, mask)))
    n_layers = cls.shape[1]
    assert set(got) == ({f'd{i}.loss_{k}' for i in range(n_layers)
                         for k in ('cls', 'bbox')}
                        | {'loss_cls', 'loss_bbox', 'total'})
    for i in range(cls.shape[0]):
        want = jax_loss(cls[i], box[i], boxes[i], labels[i], mask[i])
        assert set(want) == set(got)
        for k, v in want.items():
            v = float(v)
            assert abs(float(got[k][i]) - v) <= TOL * max(1.0, abs(v)), (
                k, float(got[k][i]), v)
    return got


def test_random_outputs_equal_jax():
    rng = np.random.RandomState(0)
    assert_losses_equal_jax(*outputs(rng), *gts(rng))


def test_perfect_predictions_equal_jax():
    """JAX's ``test_head_loss_perfect_predictions``: two GTs predicted
    exactly by queries 0 and 1 with confident scores."""
    boxes = np.array([[[1.0, 2.0, -0.5, 2.0, 4.0, 1.5, 0.3, 0.5, 0.0],
                       [-3.0, 1.0, -0.4, 1.8, 4.2, 1.6, -0.7, 0.0, 0.0]]],
                     np.float32)
    labels = np.array([[0, 2]], np.int32)
    mask = np.array([[True, True]])
    codes = np.asarray(jax_normalize_bbox(boxes[0]))
    nq, n_layers = 16, 2
    preds = np.full((nq, 10), 100.0, np.float32)
    preds[:2] = codes
    cls = np.full((nq, 4), -12.0, np.float32)
    cls[0, 0] = cls[1, 2] = 12.0
    got = assert_losses_equal_jax(
        np.tile(cls, (1, n_layers, 1, 1)), np.tile(preds, (1, n_layers, 1, 1)),
        boxes, labels, mask)
    assert float(got['loss_bbox'][0]) < 1e-4
    assert float(got['loss_cls'][0]) < 1e-2


def test_no_valid_gt_equals_jax():
    rng = np.random.RandomState(2)
    cls, box = outputs(rng)
    got = assert_losses_equal_jax(cls, box, *gts(rng, n_valid=(0, 0)))
    assert (got['loss_bbox'] == 0).all()


def _query0_case(pad):
    """One GT predicted exactly by query 0 (and a second by query 5),
    followed by ``pad`` padded slots."""
    boxes = np.zeros((1, 2 + pad, 9), np.float32)
    boxes[0, 0] = [1.0, 2.0, -0.5, 2.0, 4.0, 1.5, 0.3, 0.5, 0.0]
    boxes[0, 1] = [-3.0, 1.0, -0.4, 1.8, 4.2, 1.6, -0.7, 0.0, 0.0]
    labels = np.zeros((1, 2 + pad), np.int32)
    labels[0, :2] = [1, 2]
    mask = np.zeros((1, 2 + pad), bool)
    mask[0, :2] = True
    codes = np.asarray(jax_normalize_bbox(boxes[0, :2]))
    rng = np.random.RandomState(3)
    cls, box = outputs(rng, b=1, n_layers=1, nq=8)
    box[0, 0, 0], box[0, 0, 5] = codes[0], codes[1]
    cls[0, 0, 0] = cls[0, 0, 5] = -12.0
    cls[0, 0, 0, 1] = cls[0, 0, 5, 2] = 12.0
    return cls, box, boxes, labels, mask


@pytest.mark.parametrize('pad', [0, 2])
def test_query0_write_mirrors_jax(pad):
    """With padded slots after a real GT matched to query 0, the padded
    slots' background write to query 0 wins in JAX (XLA's last write), so
    query 0 stays positive with the background label and a zero target;
    the port resolves the writes the same way.  Without padding query 0
    keeps its GT's label."""
    cls, box, boxes, labels, mask = _query0_case(pad)
    got = assert_losses_equal_jax(cls, box, boxes, labels, mask)
    codes = torch.from_numpy(np.array(jax_normalize_bbox(boxes[0])))[None]
    matched, pos = hungarian_match(t(cls[:, 0]), t(box[:, 0]), codes,
                                   t(labels), t(mask))
    assert matched[0, :2].tolist() == [0, 5] and bool(pos[0, 0])
    lab, target = assign_targets(matched, t(labels), codes, t(mask), 8, 4)
    assert int(lab[0, 5]) == 2
    if pad:
        assert int(lab[0, 0]) == 4 and not target[0, 0].any()
        assert float(got['loss_bbox'][0]) > 0.1     # query 0 against zeros
    else:
        assert int(lab[0, 0]) == 1
        torch.testing.assert_close(target[0, 0], codes[0, 0])
        assert float(got['loss_bbox'][0]) < 1e-4


def test_f64_gradients_equal_jax():
    rng = np.random.RandomState(4)
    cls, box = outputs(rng, dtype=np.float64)
    boxes, labels, mask = gts(rng, dtype=np.float64)
    cls_t = t(cls).requires_grad_()
    box_t = t(box).requires_grad_()
    loss = bevformer_head_loss(cls_t, box_t, t(boxes), t(labels),
                               t(mask))['total']
    loss.sum().backward()
    with jax.enable_x64(True):
        for i in range(cls.shape[0]):
            gc, gb = jax.grad(lambda c, b: jax_loss(
                c, b, boxes[i], labels[i], mask[i])['total'],
                argnums=(0, 1))(jnp.asarray(cls[i]), jnp.asarray(box[i]))
            for got, want in ((cls_t.grad[i], gc), (box_t.grad[i], gb)):
                want = np.asarray(want)
                assert want.dtype == np.float64
                err = float(np.abs(got.numpy() - want).max())
                assert err <= GRAD_TOL * float(np.abs(want).max()), err


def test_config_equals_jax():
    from omnihd_scenes_tpu.models.bevformer.head import DETRLossCfg as Jax

    assert tuple(DETRLossCfg()) == tuple(Jax())


# -- GridMask -----------------------------------------------------------------

def jax_draws(key, h, w, max_d=None, prob=0.7):
    """The draws JAX's ``grid_mask`` makes from ``key``, replayed."""
    if max_d is None:
        max_d = max(min(h, w) // 2, 3)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return GridMaskDraws(int(jax.random.randint(k1, (), 2, max_d)),
                         int(jax.random.randint(k2, (), 0, max_d)),
                         int(jax.random.randint(k3, (), 0, max_d)),
                         bool(jax.random.uniform(k4) < prob))


@pytest.mark.parametrize('seed', range(6))
def test_grid_mask_equals_jax_on_equal_draws(seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(2, 3, 40, 56, 3).astype(np.float32)
    prob = (0.7, 1.0, 0.0)[seed % 3]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_grid_mask(imgs, key, prob=prob))
    got = grid_mask(t(imgs), jax_draws(key, 40, 56, prob=prob)).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_mask_fraction():
    """JAX's ``test_masks_fraction``, on the port's own draws: with
    ``prob=1.0`` something is masked and not everything."""
    imgs = torch.ones(2, 16, 16, 3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        draws = grid_mask_draws(16, 16, gen, prob=1.0)
        assert draws.apply and 2 <= draws.d < 8
        frac = float(grid_mask(imgs, draws).mean())
        assert 0.05 < frac < 0.95, (draws, frac)
    off = grid_mask_draws(16, 16, gen, prob=0.0)
    assert not off.apply and torch.equal(grid_mask(imgs, off), imgs)
