"""The whole serving slice: the port's ``Predictor`` on the CPU against
JAX ``BEVFusion.apply`` + ``anchor_head_get_bboxes``, with shared
weights, at the mini configuration of ``tests/test_full_graph_parity.py``
in the serving modes (``splat_mode='sample'``, ``pillar_impl='dense'``),
batch 2, f32.

Tolerances: the fused BEV and head maps within 1e-3 of the reference's
largest magnitude (gain-normalised; f32 convs summed in another order);
decoded boxes at the JAX package's top-k indices within 1e-3 per column
after dividing by the decode gain (anchor diagonal, height, size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg, anchor_head_decode_candidates,
    anchor_head_get_bboxes)
from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample
from omnihd_scenes_tpu_torch.models.anchor_head import decode_at
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.weights import flax_to_torch
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           mini_inputs, mini_variables)

torch.set_num_threads(1)

TOL = 1e-3


def _batch2():
    pts, mask, imgs, rots, trans = mini_inputs()
    rng = np.random.RandomState(21)
    pts2 = pts.copy()
    pts2[..., :2] = rng.uniform(-7, 7, pts2[..., :2].shape)
    imgs2 = rng.randn(*imgs.shape).astype(np.float32)
    return (np.concatenate([pts, pts2]), np.concatenate([mask, mask]),
            np.concatenate([imgs, imgs2]), np.concatenate([rots, rots]),
            np.concatenate([trans, trans]))


@pytest.fixture(scope='module')
def slice_outputs():
    inputs = _batch2()
    variables = mini_variables()
    model = JaxBEVFusion(JAX_MINI_CFG)
    out = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, *inputs)
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}
    anchors = JAX_MINI_CFG.pillars.anchors()
    cfg = JaxDecodeCfg()

    def decode(cls, box, dirp):
        lmax = jnp.max(cls.reshape(-1, 4), -1)
        idx = jax.lax.top_k(jax.nn.sigmoid(lmax),
                            min(cfg.nms_pre, lmax.shape[0]))[1]
        return (anchor_head_decode_candidates(cls, box, dirp, anchors, cfg),
                anchor_head_get_bboxes(cls, box, dirp, anchors, cfg), idx)

    cands, final, idx = jax.tree.map(np.asarray, jax.jit(jax.vmap(decode))(
        out['cls_score'], out['bbox_pred'], out['dir_pred']))
    cands = [tuple(c[s] for c in cands) for s in range(2)]
    final = [tuple(f[s] for f in final) for s in range(2)]

    launches = lss_sample.launches
    predictor = Predictor(PORT_MINI_CFG,
                          flax_to_torch(variables, PORT_MINI_CFG),
                          device='cpu', dtype=torch.float32)
    port_out = {k: v.numpy() for k, v in
                predictor.forward(*inputs).items()}
    port_final = [t.numpy() for t in predictor(*inputs)]
    return dict(out=out, cands=cands, final=final, idx=idx,
                anchors=anchors, port_out=port_out, port_final=port_final,
                launches=lss_sample.launches - launches)


def assert_close_gain(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize('key', ['bev', 'cls_score', 'bbox_pred', 'dir_pred',
                                 'depth', 'depth_logits'])
def test_fused_bev_and_head_maps(slice_outputs, key):
    assert_close_gain(slice_outputs['port_out'][key],
                      slice_outputs['out'][key])


def test_decoded_boxes_at_jax_indices(slice_outputs):
    po, anchors = slice_outputs['port_out'], slice_outputs['anchors']
    t = torch.from_numpy
    boxes, scores = decode_at(t(po['cls_score']), t(po['bbox_pred']),
                              t(po['dir_pred']), t(anchors),
                              torch.tensor(slice_outputs['idx'],
                                           dtype=torch.int64))
    an = anchors.reshape(-1, 9)
    diag = float(np.sqrt(an[:, 3] ** 2 + an[:, 4] ** 2).max())
    for s, (want_boxes, want_scores) in enumerate(slice_outputs['cands']):
        gain = np.array([diag, diag, an[:, 5].max(), *want_boxes[:, 3:6]
                         .max(0), 1.0, diag, diag])
        err = np.abs(boxes[s].numpy() - want_boxes) / np.maximum(gain, 1.0)
        assert float(err.max()) < TOL, float(err.max())
        assert float(np.abs(scores[s].numpy() - want_scores).max()) < TOL


def test_nms_on_jax_candidates(slice_outputs):
    """The port's NMS on the JAX candidates keeps exactly what JAX keeps."""
    for (boxes, scores), want in zip(slice_outputs['cands'],
                                     slice_outputs['final']):
        got = [o.numpy() for o in multiclass_nms_rotated(
            torch.tensor(boxes), torch.tensor(scores), 0.05, 0.2, 500)]
        valid = want[3]
        assert valid.sum() > 10
        np.testing.assert_array_equal(got[3], valid)
        np.testing.assert_array_equal(got[2][valid], want[2][valid])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][valid], want[0][valid])


def test_predictor_end_to_end(slice_outputs):
    """Predictor outputs: the serving shapes, finite, and the same kept
    (label, score, box) rows as the JAX graph.  Rows of exactly tied
    scores may come in another order (top-k tie order), so the kept rows
    are matched as multisets, each to its nearest row."""
    boxes, scores, labels, valid = slice_outputs['port_final']
    assert boxes.shape == (2, 500, 9) and scores.shape == (2, 500)
    assert labels.shape == valid.shape == (2, 500)
    assert labels.dtype == np.int32 and valid.dtype == bool
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
    for s, want in enumerate(slice_outputs['final']):
        np.testing.assert_array_equal(valid[s], want[3])
        np.testing.assert_array_equal(labels[s], want[2])
        assert float(np.abs(scores[s] - want[1]).max()) < TOL
        keep = want[3]
        gain = np.abs(want[0][keep]).max(0)
        rows_t = np.concatenate([boxes[s][keep] / gain, scores[s][keep, None],
                                 100.0 * labels[s][keep, None]], -1)
        rows_j = np.concatenate([want[0][keep] / gain, want[1][keep, None],
                                 100.0 * want[2][keep, None]], -1)
        d = np.abs(rows_t[:, None] - rows_j[None]).max(-1)
        assert float(d.min(1).max()) < TOL and float(d.min(0).max()) < TOL


def test_cpu_path_launches_no_kernel(slice_outputs):
    assert slice_outputs['launches'] == 0
