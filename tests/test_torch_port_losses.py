"""The training losses of the port against the JAX package, f32, jitted
JAX: sigmoid focal, smooth-L1 and softmax CE element-wise (1e-6 of
max|ref| + 1e-7), the nearest-BEV IoU within 1e-6, ``assign_targets``
(labels, label weights, bbox weights, direction targets and positive
counts exactly equal; bbox targets within 1e-6), ``anchor_head_loss``
(per-sample, vmapped and averaged in JAX, batched in the port) and
``depth_dist_loss`` within 1e-5 relative, on the mini configuration's
anchor grid with GT boxes near anchors, padded rows and yaws across the
direction bins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models import losses as jl
from omnihd_scenes_tpu.models.anchor_head import (
    HeadLossConfig as JaxHeadLossConfig, anchor_head_loss as jax_head_loss)
from omnihd_scenes_tpu.models.bevfusion import (
    depth_dist_loss as jax_depth_loss)
from omnihd_scenes_tpu.models.target_assign import (
    assign_targets as jax_assign)
from omnihd_scenes_tpu.ops.boxes3d import (
    bbox_overlaps_nearest_3d as jax_overlaps, encode_boxes as jax_encode)
from omnihd_scenes_tpu_torch.models import losses as pl
from omnihd_scenes_tpu_torch.models.anchor_head import (HeadLossConfig,
                                                        anchor_head_loss)
from omnihd_scenes_tpu_torch.models.bevfusion import depth_dist_loss
from omnihd_scenes_tpu_torch.models.target_assign import assign_targets
from omnihd_scenes_tpu_torch.ops.boxes3d import (bbox_overlaps_nearest_3d,
                                                 encode_boxes, gravity_center)
from tests.test_torch_port_weights import JAX_MINI_CFG

torch.set_num_threads(1)

ANCHORS = JAX_MINI_CFG.pillars.anchors()          # (8, 8, 8, 9)
FLAT = ANCHORS.reshape(-1, 9)
T = torch.from_numpy


def gt_batch(seed=5, b=2, g=10):
    """GT boxes: most near an anchor (so the assigner finds positives,
    some forced), two far off, the last two rows padding."""
    rng = np.random.RandomState(seed)
    pick = rng.choice(len(FLAT), (b, g))
    boxes = FLAT[pick].copy()
    boxes[..., :3] += rng.uniform(-0.3, 0.3, (b, g, 3))
    boxes[..., 3:6] *= rng.uniform(0.8, 1.25, (b, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    boxes[..., 7:] = rng.randn(b, g, 2)
    boxes[:, 6:8, :2] = rng.uniform(-7, 7, (b, 2, 2))
    labels = rng.randint(0, 4, (b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[:, -2:] = False
    return boxes.astype(np.float32), labels, mask


def close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def test_elementwise_losses():
    rng = np.random.RandomState(0)
    logits = (rng.randn(64, 4) * 4).astype(np.float32)
    onehot = (rng.uniform(size=(64, 4)) < 0.3).astype(np.float32)
    close(pl.sigmoid_focal_loss(T(logits), T(onehot)),
          jax.jit(jl.sigmoid_focal_loss)(logits, onehot), 1e-6, 1e-7)
    pred = rng.randn(64, 9).astype(np.float32) * 0.3
    tgt = rng.randn(64, 9).astype(np.float32) * 0.3
    close(pl.smooth_l1(T(pred), T(tgt)), jax.jit(jl.smooth_l1)(pred, tgt),
          1e-6, 1e-7)
    labels = rng.randint(0, 2, 64).astype(np.int32)
    close(pl.softmax_cross_entropy(T(logits[:, :2]), T(labels)),
          jax.jit(jl.softmax_cross_entropy)(logits[:, :2], labels), 1e-6,
          1e-7)


def test_box_geometry():
    boxes, _, _ = gt_batch()
    close(bbox_overlaps_nearest_3d(T(boxes), T(FLAT)),
          jax.vmap(jax.jit(jax_overlaps), (0, None))(boxes, FLAT), 1e-6)
    close(encode_boxes(T(FLAT[:10]), T(boxes[0])),
          jax.jit(jax_encode)(FLAT[:10], boxes[0]), 1e-6)
    np.testing.assert_array_equal(
        gravity_center(T(boxes)).numpy()[..., 2],
        boxes[..., 2] + boxes[..., 5] * 0.5)


@pytest.fixture(scope='module')
def targets():
    boxes, labels, mask = gt_batch()
    want = jax.jit(jax.vmap(lambda b, l, m: jax_assign(FLAT, b, l, m, 4),
                            (0, 0, 0)))(boxes, labels, mask)
    got = assign_targets(T(FLAT), T(boxes), T(labels), T(mask), 4)
    return got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize('field', ['labels', 'label_weights', 'bbox_weights',
                                   'dir_targets', 'num_pos'])
def test_assign_targets_exact(targets, field):
    got, want = targets
    g, w = getattr(got, field).numpy(), getattr(want, field)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def test_assign_targets_cases(targets):
    """The case really has positives, negatives, ignored anchors, both
    direction bins and GT-forced matches below the positive threshold."""
    got, want = targets
    assert int(want.num_pos.min()) >= 3
    lw = want.label_weights
    assert (lw == 0).any() and (lw == 1).any()
    dirs = want.dir_targets[want.bbox_weights > 0]
    assert set(np.unique(dirs)) == {0, 1}
    close(got.bbox_targets, want.bbox_targets, 1e-6)


@pytest.fixture(scope='module')
def head_maps():
    rng = np.random.RandomState(9)
    h, w, a = ANCHORS.shape[:3]
    return ((rng.randn(2, h, w, a * 4) * 2).astype(np.float32),
            (rng.randn(2, h, w, a * 9) * 0.2).astype(np.float32),
            rng.randn(2, h, w, a * 2).astype(np.float32))


def test_anchor_head_loss(head_maps):
    boxes, labels, mask = gt_batch()
    cls, box, dirp = head_maps

    def jax_loss(c, bx, d, gb, gl, gm):
        per = jax.vmap(lambda *x: jax_head_loss(*x[:3], ANCHORS, *x[3:],
                                                cfg=JaxHeadLossConfig()))(
            c, bx, d, gb, gl, gm)
        return {k: jnp.mean(v) for k, v in per.items()}

    want = jax.jit(jax_loss)(cls, box, dirp, boxes, labels, mask)
    got = anchor_head_loss(T(cls), T(box), T(dirp), T(ANCHORS), T(boxes),
                           T(labels), T(mask), HeadLossConfig())
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
    assert float(want['loss_bbox']) > 0 and float(want['loss_dir']) > 0


@pytest.mark.parametrize('method', ['kld', 'mse'])
def test_depth_dist_loss(method):
    rng = np.random.RandomState(4)
    shape = (2, 6, 16, 28)
    pred = jax.nn.softmax(rng.randn(*shape, 8).astype(np.float32), -1)
    pred = np.array(pred)
    gt = rng.uniform(size=shape + (8,)).astype(np.float32)
    gt /= gt.sum(-1, keepdims=True)
    gt[0, 0, 0, 0] = 0.0                         # log(clip(0)) branch
    d_min = rng.uniform(-2, 12, shape).astype(np.float32)  # some outside
    rng_ = (1.0, 9.0, 1.0)
    want = jax.jit(lambda *a: jax_depth_loss(*a, rng_, method))(pred, gt,
                                                                d_min)
    got = depth_dist_loss(T(pred), T(gt), T(d_min), rng_, method)
    close(got.numpy(), want, 1e-5)
