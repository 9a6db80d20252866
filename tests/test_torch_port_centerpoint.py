"""The port's CenterPoint head (``models/centerpoint_head.py``) against
the JAX package's, with flax's weights carried over by the bridge
(``weights.py:CenterHeadSpec``):

* the forward (eval mode, and train mode with its new BatchNorm
  statistics) within 1e-4 of max|ref| of each map;
* the targets of each sample: heatmap within 1e-6, regression targets
  within 1e-6 of max|ref|, the grid indices gy / gx and the valid mask
  equal.  The port divides by the cell sizes as device tensors (a true
  division on every device), which is what the JAX function computes
  eagerly, so the indices are held to JAX's eager result, at centres
  placed on cell boundaries too;
* each sample's loss within 1e-5 relative; the f64 gradient of the loss
  with respect to every prediction map within 1e-5 of max|ref| per map;
* the decode's valid boxes, scores and classes equal JAX's as multisets
  (within 1e-5);
* the mirrored ``num_classes = int(4)`` of ``build_center_targets``: the
  heatmap target has 4 channels whatever the labels, labels from 4 up
  splat nothing, and a head of another class count cannot take the loss
  in either package.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models import centerpoint_head as J
from omnihd_scenes_tpu_torch.models import centerpoint_head as P
from omnihd_scenes_tpu_torch.weights import (CenterHeadSpec, flax_to_torch,
                                             load_state_dict, torch_to_flax)

CFG_KW = dict(pc_range=(-8, -8, -3.0, 8, 8, 5.0), out_hw=(16, 24))
JCFG, PCFG = J.CenterTargetCfg(**CFG_KW), P.CenterTargetCfg(**CFG_KW)
IN_CH, B = 16, 2
MAPS = ('heatmap', 'reg', 'height', 'dim', 'rot', 'vel')


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.fixture(scope='module')
def heads():
    """A flax CenterHead with random BatchNorm statistics and affine
    parameters, and the port's head loaded from it through the bridge."""
    rng = np.random.RandomState(0)
    bev = rng.randn(B, 16, 24, IN_CH).astype(np.float32)
    head = J.CenterHead(num_classes=4)
    variables = jax.tree.map(np.asarray, head.init(
        jax.random.PRNGKey(0), bev, train=False))
    for coll, key, lo, hi in (('batch_stats', 'mean', -0.5, 0.5),
                              ('batch_stats', 'var', 0.5, 2.0),
                              ('params', 'scale', 0.5, 1.5),
                              ('params', 'bias', -0.3, 0.3)):
        for mod in variables[coll].values():
            if 'BatchNorm_0' not in mod:
                continue
            bn = mod['BatchNorm_0']
            bn[key] = rng.uniform(lo, hi, bn[key].shape).astype(np.float32)
    port = P.CenterHead(IN_CH, num_classes=4)
    load_state_dict(port, flax_to_torch(variables, CenterHeadSpec()))
    return head, variables, port, bev


def _to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_forward_matches_jax(heads, train):
    head, variables, port, bev = heads
    if train:
        want, new = head.apply(variables, bev, train=True,
                               mutable=['batch_stats'])
    else:
        want = head.apply(variables, bev, train=False)
    port = copy.deepcopy(port).train(train)
    with torch.no_grad():
        got = port(_to_port(bev))
    for name in MAPS:
        assert _rel(_to_nhwc(got[name]), np.asarray(want[name])) < 1e-4, name
    if train:
        stats = flax_to_torch({'batch_stats': new['batch_stats']},
                              CenterHeadSpec(), collections=('batch_stats',))
        sd = port.state_dict()
        for key, v in stats.items():
            assert _rel(sd[key].numpy(), v.numpy()) < 1e-4, key


def test_bridge_round_trip(heads):
    _, variables, port, _ = heads
    back = torch_to_flax(port.state_dict(), CenterHeadSpec())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    for path, v in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, v)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))


def gt_batch(seed=1, g=6):
    """Padded GT of B samples: boxes inside the grid (two centred exactly
    on cell boundaries), one outside it, one masked out, one labelled 5."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, g, 9), np.float32)
    boxes[..., 0] = rng.uniform(-7.5, 7.5, (B, g))
    boxes[..., 1] = rng.uniform(-7.5, 7.5, (B, g))
    boxes[..., 2] = rng.uniform(-1, 0, (B, g))
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (B, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, g))
    boxes[..., 7:9] = rng.uniform(-3, 3, (B, g, 2))
    sx, sy = 16 / 24, 16 / 16
    boxes[0, 0, :2] = (-8 + 7 * sx, -8 + 3 * sy)       # on a cell corner
    boxes[1, 0, :2] = (-8 + 13 * sx, 0.0)
    boxes[1, 1, 0] = 9.0                               # outside the grid
    labels = rng.randint(0, 4, (B, g)).astype(np.int32)
    labels[1, 2] = 5
    mask = np.ones((B, g), bool)
    mask[0, g - 1] = False
    return boxes, labels, mask


def _jax_targets(boxes, labels, mask):
    return [jax.tree.map(np.asarray, J.build_center_targets(
        jnp.asarray(boxes[i]), jnp.asarray(labels[i]), jnp.asarray(mask[i]),
        JCFG)) for i in range(B)]


def test_targets_match_jax_eager():
    boxes, labels, mask = gt_batch()
    got = P.build_center_targets(*map(torch.from_numpy, (boxes, labels,
                                                          mask)), PCFG)
    for i, want in enumerate(_jax_targets(boxes, labels, mask)):
        for k in ('gy', 'gx', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(), want[k], k)
        np.testing.assert_allclose(
            got['heatmap'][i].permute(1, 2, 0).numpy(), want['heatmap'],
            rtol=0, atol=1e-6)
        assert _rel(got['targets'][i].numpy(), want['targets']) < 1e-6
    # The boundary centres sit on their cells' low edges.
    assert (got['gx'][0, 0], got['gy'][0, 0]) == (7, 3)
    assert got['gx'][1, 0] == 13
    assert not got['valid'][1, 1] and not got['valid'][0, -1]


def test_num_classes_four_is_mirrored():
    """``build_center_targets`` codes labels over 4 classes whatever the
    head's class count (JAX's ``num_classes = int(4)``); a 6-class head's
    heatmap cannot meet that target in either package."""
    boxes, labels, mask = gt_batch()
    labels = labels.copy()
    labels[0, :3] = (4, 5, 3)
    got = P.build_center_targets(*map(torch.from_numpy, (boxes, labels,
                                                          mask)), PCFG)
    assert got['heatmap'].shape == (B, 4, 16, 24)
    want = _jax_targets(boxes, labels, mask)
    for i in range(B):
        assert want[i]['heatmap'].shape == (16, 24, 4)
        np.testing.assert_allclose(
            got['heatmap'][i].permute(1, 2, 0).numpy(), want[i]['heatmap'],
            rtol=0, atol=1e-6)
    six = {name: torch.zeros(B, 6 if name == 'heatmap' else w, 16, 24)
           for name, w in (('heatmap', 0),) + P.REG_BRANCHES}
    with pytest.raises(RuntimeError):
        P.center_head_loss(six, *map(torch.from_numpy, (boxes, labels,
                                                         mask)), PCFG)
    jsix = {k: jnp.zeros((16, 24, v.shape[1])) for k, v in six.items()}
    with pytest.raises((TypeError, ValueError)):
        J.center_head_loss(jsix, jnp.asarray(boxes[0]),
                           jnp.asarray(labels[0]), jnp.asarray(mask[0]),
                           JCFG)


def _preds(seed=2, dtype=np.float32):
    rng = np.random.RandomState(seed)
    widths = dict((('heatmap', 4),) + P.REG_BRANCHES)
    return {k: rng.randn(B, 16, 24, w).astype(dtype)
            for k, w in widths.items()}


def test_loss_matches_jax():
    boxes, labels, mask = gt_batch()
    preds = _preds()
    got = P.center_head_loss({k: _to_port(v) for k, v in preds.items()},
                             *map(torch.from_numpy, (boxes, labels, mask)),
                             PCFG)
    for i in range(B):
        want = J.center_head_loss(
            {k: jnp.asarray(v[i]) for k, v in preds.items()},
            jnp.asarray(boxes[i]), jnp.asarray(labels[i]),
            jnp.asarray(mask[i]), JCFG)
        for k in ('loss_heatmap', 'loss_bbox'):
            np.testing.assert_allclose(got[k][i].item(), float(want[k]),
                                       rtol=1e-5, atol=0)


def test_f64_gradient_matches_jax():
    boxes, labels, mask = gt_batch()
    preds = _preds(dtype=np.float64)
    tp = {k: _to_port(v).requires_grad_() for k, v in preds.items()}
    losses = P.center_head_loss(tp, torch.from_numpy(boxes).double(),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask), PCFG)
    (losses['loss_heatmap'] + losses['loss_bbox']).sum().backward()
    with jax.enable_x64(True):
        def total(p, i):
            out = J.center_head_loss(
                p, jnp.asarray(boxes[i], jnp.float64),
                jnp.asarray(labels[i]), jnp.asarray(mask[i]), JCFG)
            return out['loss_heatmap'] + out['loss_bbox']

        for i in range(B):
            want = jax.grad(total)(
                {k: jnp.asarray(v[i]) for k, v in preds.items()}, i)
            for k in MAPS:
                g = tp[k].grad[i].permute(1, 2, 0).numpy()
                assert g.dtype == np.float64
                assert _rel(g, np.asarray(want[k])) < 1e-5, k


def _rows(boxes, scores, cls, valid):
    keep = np.asarray(valid)
    rows = np.concatenate([np.asarray(boxes)[keep],
                           np.asarray(scores)[keep, None],
                           np.asarray(cls)[keep, None].astype(np.float64)],
                          1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize('max_num', [40, 2000], ids=['top40', 'padded'])
def test_decode_matches_jax_as_multisets(heads, max_num):
    head, variables, port, bev = heads
    preds = {k: np.array(v) for k, v in
             head.apply(variables, bev, train=False).items()}
    # A few confident peaks on top of the head's own maps.
    preds['heatmap'][0, 3, 5, 1] = 4.0
    preds['heatmap'][1, 10, 20, 3] = 3.0
    got = P.center_head_decode({k: _to_port(v) for k, v in preds.items()},
                               PCFG, max_num=max_num)
    assert got[0].shape == (B, max_num, 9)
    n_valid = 0
    for i in range(B):
        want = J.center_head_decode({k: jnp.asarray(v[i])
                                     for k, v in preds.items()},
                                    JCFG, max_num=max_num)
        g, w = _rows(*(t[i].numpy() for t in got)), _rows(*want)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        n_valid += len(w)
    assert n_valid > 2
