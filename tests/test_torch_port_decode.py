"""Head, box decode, rotated IoU and rotated NMS of the port against the
JAX package, f32.

``torch.topk`` and ``blocked_top_k`` may order tied keys differently, so
the candidate decode is compared at the JAX package's indices (as
``tests/test_full_graph_parity.py:test_decoded_boxes_parity`` does) and
through the sorted scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models import anchor_head as jax_head
from omnihd_scenes_tpu.ops import boxes3d as jax_boxes
from omnihd_scenes_tpu.ops import nms as jax_nms
from omnihd_scenes_tpu_torch.config import DecodeCfg
from omnihd_scenes_tpu_torch.models import anchor_head as port_head
from omnihd_scenes_tpu_torch.ops import boxes3d as port_boxes
from omnihd_scenes_tpu_torch.ops import nms as port_nms
from tests.test_torch_port_weights import PORT_MINI_CFG, random_variables

torch.set_num_threads(1)

PC = PORT_MINI_CFG.pillars
CFG = DecodeCfg(nms_pre=100, max_num=60)


def _head_outputs(seed, b=2):
    rng = np.random.RandomState(seed)
    h, w = PC.head_hw
    a = PC.num_anchors
    cls = rng.randn(b, h, w, a * PC.num_classes).astype(np.float32)
    box = (0.3 * rng.randn(b, h, w, a * 9)).astype(np.float32)
    dirp = rng.randn(b, h, w, a * 2).astype(np.float32)
    return cls, box, dirp


def _rand_boxes(rng, n, spread=6.0):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.8, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.randn(n, 2)
    b[n // 4:n // 4 + 3] = b[0]                       # exact duplicates
    b[n // 2, 6] = b[n // 2 + 1, 6] = 0.0             # edge-touching pair
    b[n // 2 + 1, :2] = b[n // 2, :2] + [b[n // 2, 3], 0.0]
    b[n // 2 + 1, 3:5] = b[n // 2, 3:5]
    return b


def test_anchor3d_head_convs():
    from omnihd_scenes_tpu.models.anchor_head import Anchor3DHead as JaxHead

    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 384).astype(np.float32)
    mod = JaxHead(num_classes=PC.num_classes, num_anchors=PC.num_anchors)
    v = random_variables(mod, x)
    want = [np.asarray(o) for o in mod.apply(v, x)]
    port = port_head.Anchor3DHead(384, PC.num_classes, PC.num_anchors)
    for i, conv in enumerate((port.conv_cls, port.conv_reg, port.conv_dir)):
        k = v['params'][f'Conv_{i}']
        conv.weight.data = torch.from_numpy(
            k['kernel'].transpose(3, 2, 0, 1).copy())
        conv.bias.data = torch.from_numpy(k['bias'].copy())
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-5)


def _jax_candidates(cls, box, dirp, anchors):
    """JAX decode of one sample + the indices its top-k chose."""
    boxes, scores = jax.jit(lambda *a: jax_head.anchor_head_decode_candidates(
        *a, cfg=jax_head.DecodeCfg(*CFG)))(cls, box, dirp, anchors)
    lmax = jnp.max(jnp.asarray(cls).reshape(-1, PC.num_classes), -1)
    _, idx = jax.lax.top_k(jax.nn.sigmoid(lmax), CFG.nms_pre)
    return np.asarray(boxes), np.asarray(scores), np.asarray(idx)


def test_decode_candidates_at_jax_indices():
    cls, box, dirp = _head_outputs(0)
    anchors = PC.anchors()
    t = torch.from_numpy
    idx = []
    for s in range(2):
        want_boxes, want_scores, jidx = _jax_candidates(
            cls[s], box[s], dirp[s], anchors)
        idx.append(jidx)
        got_boxes, got_scores = port_head.decode_at(
            t(cls[s]), t(box[s]), t(dirp[s]), t(anchors),
            torch.tensor(jidx, dtype=torch.int64), CFG)
        np.testing.assert_allclose(got_boxes.numpy(), want_boxes,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_scores.numpy(), want_scores,
                                   rtol=1e-6, atol=1e-6)
        # the port's own top-k: same sorted keys
        cand_boxes, cand_scores = port_head.anchor_head_decode_candidates(
            t(cls[s]), t(box[s]), t(dirp[s]), t(anchors), CFG)
        np.testing.assert_allclose(
            np.sort(cand_scores.max(-1).values.numpy()),
            np.sort(want_scores.max(-1)), rtol=1e-6, atol=1e-7)
    # batched call == per-sample calls (sigmoid to an ulp: the CPU
    # kernel's vectorised body and scalar tail round differently)
    bb, bs = port_head.decode_at(t(cls), t(box), t(dirp), t(anchors),
                                 torch.tensor(np.stack(idx)).long(), CFG)
    for s in range(2):
        ob, os_ = port_head.decode_at(t(cls[s]), t(box[s]), t(dirp[s]),
                                      t(anchors), torch.tensor(idx[s]).long(),
                                      CFG)
        torch.testing.assert_close(bb[s], ob, rtol=0, atol=0)
        torch.testing.assert_close(bs[s], os_, rtol=1e-6, atol=1e-7)


def test_rotated_iou_bev():
    rng = np.random.RandomState(9)
    b1, b2 = _rand_boxes(rng, 60), _rand_boxes(rng, 70)
    b2[:5] = b1[:5]
    want = np.asarray(jax.jit(jax_boxes.rotated_iou_bev)(b1, b2))
    got = port_boxes.rotated_iou_bev(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy()
    assert (want > 0.2).sum() > 10
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.diag(got[:5, :5]), 1.0, atol=1e-5)


def test_limit_period_and_decode_boxes():
    rng = np.random.RandomState(2)
    ang = rng.uniform(-10, 10, 200).astype(np.float32)
    for off in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            port_boxes.limit_period(torch.from_numpy(ang), off).numpy(),
            np.asarray(jax_boxes.limit_period(ang, off)), atol=1e-5)
    an = _rand_boxes(rng, 50)
    deltas = (0.2 * rng.randn(50, 9)).astype(np.float32)
    np.testing.assert_allclose(
        port_boxes.decode_boxes(torch.from_numpy(an),
                                torch.from_numpy(deltas)).numpy(),
        np.asarray(jax_boxes.decode_boxes(an, deltas)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('n,max_num', [(200, 60), (40, 500)],
                         ids=['truncated', 'padded'])
def test_multiclass_nms_keep_sets(n, max_num):
    rng = np.random.RandomState(n)
    boxes = _rand_boxes(rng, n, spread=4.0)
    scores = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    scores[::7] = 0.01                                  # below score_thr
    want = [np.asarray(o) for o in jax.jit(
        lambda b, s: jax_nms.multiclass_nms_rotated(b, s, 0.05, 0.2,
                                                    max_num))(boxes, scores)]
    got = [o.numpy() for o in port_nms.multiclass_nms_rotated(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, 0.2,
        max_num)]
    assert [g.shape for g in got] == [w.shape for w in want]
    valid = want[3]
    kept = int(valid.sum())
    # truncated: more kept pairs than max_num; padded: suppression leaves
    # fewer than the candidate pairs and the tail is padding
    assert kept == max_num if max_num < n else 0 < kept < (scores > 0.05).sum()
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][valid], want[0][valid])


def test_get_bboxes_batched():
    """Decode + NMS on two samples at once against JAX per sample."""
    cls, box, dirp = _head_outputs(3)
    anchors = PC.anchors()
    t = torch.from_numpy
    got = port_head.anchor_head_get_bboxes(t(cls), t(box), t(dirp),
                                           t(anchors), CFG)
    f = jax.jit(lambda *a: jax_head.anchor_head_get_bboxes(
        *a, cfg=jax_head.DecodeCfg(*CFG)))
    for s in range(2):
        want = [np.asarray(o) for o in f(cls[s], box[s], dirp[s], anchors)]
        valid = want[3]
        assert valid.sum() > 5
        np.testing.assert_array_equal(got[3][s].numpy(), valid)
        np.testing.assert_array_equal(got[2][s].numpy()[valid],
                                      want[2][valid])
        np.testing.assert_allclose(got[1][s].numpy(), want[1], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[0][s].numpy()[valid], want[0][valid],
                                   rtol=1e-5, atol=1e-5)
