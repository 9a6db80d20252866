"""The pillar detectors of the port against the JAX package on the CPU:
``PointPillars`` on radar points (sorted and dense pillars), RadarPillarNet
(``with_velocity_snr_center``) and on LiDAR points (4 dims, 64 points per
pillar), at a mini configuration (16x16 pillar grid, SECOND 64/128/256,
FPN 3x128), batch 2, with weights and inputs made by NumPy from a seed.

* eval-mode forward: the head maps and the BEV within 1e-3 of max|ref|;
* decode + rotated NMS: the same kept (box, score, label) rows, matched
  as multisets (``chip_smoke.py:kept_row_distance``) within 1e-3;
* one training step in f64 in both packages (JAX under
  ``jax.enable_x64``): the loss within 1e-6 and every gradient leaf within
  1e-5 of its max|ref|, on conditioned weights (BatchNorm biases near +4)
  and on the weights as drawn, where the ReLU masks clip.  JAX's gradient
  is taken eagerly: under ``jax.jit`` on the CPU, XLA's gradient of the
  PFN leaves through the pillar scatter (``.at[iy, ix].set``, and ``.add``
  too) was off by up to 9 % of max|ref| in f64 and in f32 when every one
  of 200 voxel slots held a pillar, where the eager gradient, the port's
  and central differences agreed (``test_pfn_gradient_by_central_
  differences`` holds the port to the latter);
* the weight bridge round-trips bit for bit.

Also home of the helpers that ``test_torch_port_lss_camera.py`` shares.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import kept_row_distance
from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg, anchor_head_get_bboxes as jax_get_bboxes)
from omnihd_scenes_tpu.models.detectors import (
    PointPillars as JaxPointPillars,
    PointPillarsConfig as JaxPointPillarsConfig)
from omnihd_scenes_tpu.train.builder import (
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu_torch import config as port_config
from omnihd_scenes_tpu_torch.models.anchor_head import anchor_head_get_bboxes
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.train.builder import (make_loss_fn_generic,
                                                   model_inputs)
from omnihd_scenes_tpu_torch.weights import (flax_to_torch,
                                             flax_tree_to_torch,
                                             load_state_dict, name_map,
                                             torch_to_flax)
from tests.test_torch_port_weights import flat_paths, random_variables

torch.set_num_threads(1)

TOL = 1e-3
PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 5.0)
MINI = JaxPointPillarsConfig(
    point_cloud_range=PC_RANGE, voxel_size=(1.0, 1.0, 8.0), max_voxels=200,
    max_points_per_voxel=8, bev_hw=(16, 16), pfn_channels=(64,),
    second_channels=(64, 128, 256), fpn_channels=(128, 128, 128),
    anchor_ranges=tuple((-8.0, -8.0, z, 8.0, 8.0, z)
                        for z in (0.91, 1.142, 0.906, 1.516)))
# (JAX config, point dims)
CASES = {
    'radar-sorted': (MINI, 8),
    'radar-dense': (dataclasses.replace(MINI, pillar_impl='dense'), 8),
    'radarpillarnet': (dataclasses.replace(
        MINI, with_velocity_snr_center=True), 8),
    'lidar': (dataclasses.replace(MINI, max_points_per_voxel=64), 4),
}


def to_port_pillars(cfg):
    return port_config.PointPillarsConfig(**dataclasses.asdict(cfg))


def pillar_points(seed, dims, b=2, n=640):
    """(points (b, n, dims), mask): points over the grid, a crowded pillar
    of 100 (past 8 and 64 points per pillar), out-of-range and padded
    rows."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7.5, 7.5, (b, n, dims)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 4, (b, n))
    pts[..., 3:] = rng.uniform(-3, 3, (b, n, dims - 3))
    pts[:, :100, :2] = rng.uniform(2.1, 2.9, (b, 100, 2))   # one pillar
    pts[:, 100:110, 0] = 9.0                                 # out of range
    mask = np.ones((b, n), bool)
    mask[:, -30:] = False
    pts[:, -30:] = 1e3                                       # padding
    return pts, mask


def gt_batch(anchors, rng, b=2, g=8):
    """GT boxes near the anchors (padded rows at the end) and labels."""
    flat = anchors.reshape(-1, 9)
    boxes = flat[rng.choice(len(flat), (b, g))].copy()
    boxes[..., :3] += rng.uniform(-0.3, 0.3, (b, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    mask = np.ones((b, g), bool)
    mask[:, -2:] = False
    return {'gt_boxes': boxes.astype(np.float32),
            'gt_labels': rng.randint(0, 4, (b, g)).astype(np.int32),
            'gt_mask': mask}


def condition(tree, path=()):
    """BatchNorm scales near 1 and biases near +4: ReLU inputs away from
    0."""
    if isinstance(tree, dict):
        return {k: condition(v, path + (k,)) for k, v in tree.items()}
    v = np.asarray(tree)
    if path[0] == 'params' and path[-2].startswith('BatchNorm'):
        v = 1 + 2 * v if path[-1] == 'scale' else 4 + v
    return v.astype(np.float32)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(
        a).dtype == np.float32 else np.asarray(a), tree)


def jax_f64_step(jax_model, mtype, anchors, variables, batch, port_cfg,
                 jit=True):
    """(loss, gradients in torch names) of JAX in f64."""
    loss_fn = jax_make_loss_fn(jax_model, mtype, anchors,
                               camera_depth_range=getattr(
                                   getattr(port_cfg, 'lss', None),
                                   'camera_depth_range', (1.0, 60.0, 1.0)))
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    if jit:
        grad_fn = jax.jit(grad_fn)
    with jax.enable_x64(True):
        (loss, _), grads = grad_fn(*_f64(
            (variables['params'], variables['batch_stats'], batch)))
        grads = {k: v.double() for k, v in flax_tree_to_torch(
            jax.tree.map(np.asarray, grads), port_cfg, 'params').items()}
    return float(loss), grads


def port_f64_step(model, mtype, anchors, variables, batch, port_cfg):
    """(loss, gradients, share of BatchNorm outputs below 0) of the port in
    f64."""
    from omnihd_scenes_tpu_torch.models.layers import BatchNorm

    load_state_dict(model, flax_to_torch(variables, port_cfg))
    model = model.double().train()
    counts = torch.zeros(2, dtype=torch.float64)

    def count(module, args, out):
        counts.add_(torch.tensor([float((out < 0).sum()), out.numel()]))

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, BatchNorm)]
    loss_fn = make_loss_fn_generic(
        model, mtype, anchors,
        camera_depth_range=getattr(getattr(port_cfg, 'lss', None),
                                   'camera_depth_range', (1.0, 60.0, 1.0)))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch = {k: v.double() if v.is_floating_point() else v
               for k, v in t_batch.items()}
    loss, _ = loss_fn(model, None, t_batch)
    loss.backward()
    for h in hooks:
        h.remove()
    return (loss.item(),
            {k: p.grad.double() for k, p in model.named_parameters()},
            float(counts[0] / counts[1]))


def assert_gradients_match(got, want, tol=1e-5, floor=1e-9):
    """Every leaf within ``tol`` of max(max|ref|, floor * largest leaf)."""
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    err = {k: float((got[k] - w).abs().max())
           / max(float(w.abs().max()), floor * top)
           for k, w in want.items()}
    bad = {k: v for k, v in err.items() if v > tol}
    assert not bad, bad


def assert_kept_rows_match(port_dets, jax_dets, batch):
    """The same number of kept rows per sample, matched as multisets."""
    t = [torch.as_tensor(np.asarray(x)) for x in jax_dets]
    p = [torch.as_tensor(np.asarray(x)) for x in port_dets]
    for s in range(batch):
        assert int(p[3][s].sum()) == int(t[3][s].sum()) > 0
        assert kept_row_distance(p, t, s) < TOL


def assert_close_gain(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
    """Both packages' forward, decode and f64 train step on one case."""
    jcfg, dims = CASES[request.param]
    pcfg = to_port_pillars(jcfg)
    pts, mask = pillar_points(5, dims)
    jax_model = JaxPointPillars(jcfg)
    variables = random_variables(jax_model, pts, mask, train=False)
    out = jax.jit(lambda v, p, m: jax_model.apply(v, p, m, train=False))(
        variables, pts, mask)
    out = {k: np.asarray(v) for k, v in out.items()}
    anchors = jcfg.anchors()
    dcfg = JaxDecodeCfg(score_thr=0.3)
    jax_dets = jax.jit(jax.vmap(lambda c, b, d: jax_get_bboxes(
        c, b, d, anchors, dcfg)))(out['cls_score'], out['bbox_pred'],
                                  out['dir_pred'])

    model = PointPillars(pcfg, dims)
    load_state_dict(model, flax_to_torch(variables, pcfg))
    model.eval()
    with torch.no_grad():
        port_out = model(*model_inputs(
            {'points': torch.from_numpy(pts),
             'points_mask': torch.from_numpy(mask)}, 'pointpillars'))
        port_dets = anchor_head_get_bboxes(
            port_out['cls_score'], port_out['bbox_pred'],
            port_out['dir_pred'], torch.from_numpy(anchors),
            port_config.DecodeCfg(score_thr=0.3))

    batch = {'points': pts, 'points_mask': mask,
             **gt_batch(anchors, np.random.RandomState(9))}
    steps = {}
    for name, v in (('conditioned', condition(variables)), ('drawn',
                                                          variables)):
        steps[name] = (
            jax_f64_step(jax_model, 'pointpillars', anchors, v, batch, pcfg,
                         jit=False),
            port_f64_step(PointPillars(pcfg, dims), 'pointpillars', anchors,
                          v, batch, pcfg))
    return dict(name=request.param, cfg=pcfg, dims=dims, variables=variables,
                out=out, port_out={k: v.numpy() for k, v in port_out.items()},
                jax_dets=jax_dets, port_dets=port_dets, steps=steps)


@pytest.mark.parametrize('key', ['bev', 'cls_score', 'bbox_pred', 'dir_pred'])
def test_forward_maps(case, key):
    assert_close_gain(case['port_out'][key], case['out'][key])


def test_decoded_rows(case):
    assert_kept_rows_match(case['port_dets'], case['jax_dets'], 2)


@pytest.mark.parametrize('weights', ['conditioned', 'drawn'])
def test_f64_train_step_gradients(case, weights):
    (j_loss, j_grads), (p_loss, p_grads, below) = case['steps'][weights]
    assert abs(p_loss - j_loss) <= 1e-6 * abs(j_loss)
    assert_gradients_match(p_grads, j_grads)
    if weights == 'drawn':            # the ReLU masks clip
        assert below > 0.2, below


def test_weight_bridge_round_trips(case):
    cfg, variables = case['cfg'], case['variables']
    back = flat_paths(torch_to_flax(flax_to_torch(variables, cfg), cfg))
    want = flat_paths(variables)
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    model = PointPillars(cfg, case['dims'])
    assert set(name_map(cfg)) == {
        k for k in model.state_dict() if not k.endswith('num_batches_tracked')}


def test_pfn_width_follows_the_point_dims():
    """The PFN's input width is the points' (radar 8 + 5, LiDAR 4 + 5,
    RadarPillarNet 8 + 9), taken at construction."""
    for name, want in (('radar-sorted', 13), ('lidar', 9),
                       ('radarpillarnet', 17)):
        jcfg, dims = CASES[name]
        model = PointPillars(to_port_pillars(jcfg), dims)
        w = model.state_dict()['pillar_encoder.pfn.0.linear.weight']
        assert w.shape == (64, want), (name, w.shape)


def test_dense_fold_builds_and_serves():
    """``pillar_impl='dense_fold'``, refused until its port, builds with
    the dense encoder's state-dict keys, and its eval-mode maps equal the
    dense model's on the same weights within 1e-5 of max|ref|
    (reassociation; ``tests/test_torch_port_dense_fold.py`` holds the
    fold to JAX's)."""
    dense = PointPillars(to_port_pillars(
        dataclasses.replace(MINI, pillar_impl='dense')), 8).eval()
    fold = PointPillars(to_port_pillars(
        dataclasses.replace(MINI, pillar_impl='dense_fold')), 8).eval()
    assert fold.pillar_encoder.fold_bn and not dense.pillar_encoder.fold_bn
    assert list(fold.state_dict()) == list(dense.state_dict())
    fold.load_state_dict(dense.state_dict())
    pts, mask = (torch.from_numpy(a) for a in pillar_points(4, 8))
    with torch.no_grad():
        want, got = dense(pts, mask), fold(pts, mask)
    for key in ('cls_score', 'bbox_pred', 'dir_pred'):
        err = (got[key] - want[key]).abs().max() / want[key].abs().max()
        assert float(err) < 1e-5, (key, float(err))


def test_pfn_gradient_by_central_differences():
    """The port's f64 gradient of the PFN BatchNorm bias, through voxelize,
    the PFN and the scatter, within 1e-6 of central differences of its
    own loss (the reference for the eager-JAX choice above)."""
    jcfg, dims = CASES['radar-sorted']
    pcfg = to_port_pillars(jcfg)
    pts, mask = pillar_points(5, dims)
    variables = condition(random_variables(JaxPointPillars(jcfg), pts, mask,
                                           train=False))
    batch = {'points': pts, 'points_mask': mask,
             **gt_batch(jcfg.anchors(), np.random.RandomState(9))}
    _, grads, _ = port_f64_step(PointPillars(pcfg, dims), 'pointpillars',
                                jcfg.anchors(), variables, batch, pcfg)
    key = 'pillar_encoder.pfn.0.bn.bias'
    model = PointPillars(pcfg, dims)
    load_state_dict(model, flax_to_torch(variables, pcfg))
    model = model.double().train()
    loss_fn = make_loss_fn_generic(model, 'pointpillars', jcfg.anchors())
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch = {k: v.double() if v.is_floating_point() else v
               for k, v in t_batch.items()}
    params = dict(model.named_parameters())
    eps = 1e-6
    for ch in range(4):
        losses = []
        for sign in (1, -1):
            p = {k: v.detach().clone() for k, v in params.items()}
            p[key][ch] += sign * eps
            losses.append(float(loss_fn(model, p, t_batch)[0]))
        fd = (losses[0] - losses[1]) / (2 * eps)
        assert abs(float(grads[key][ch]) - fd) <= 1e-6 * max(
            1.0, float(grads[key].abs().max())), (ch, fd)
