"""BEVFusion-OCC (``BEVFusionMTL``) of the port against the JAX package on
the CPU, through the weight bridge, at a narrow form of the mini fusion
configuration of ``tests/test_torch_port_train.py`` (64x112 images, six
cameras, sorted pillars, the sampling splat, DepthNet; ResNet18 and
64/96-channel BEVs so JAX's f64 gradient compiles in under a minute; the
BEV at 1 m, 16x16, so that the task trunks' stride-8 stage keeps 2x2
cells: at 1x1 with batch 2 its train-mode BatchNorms see two values per
channel whose variance falls far below epsilon and the f64 gradient
turns ill-conditioned), batch 2, occupancy 16x16x4 over 12 classes,
weights and inputs made by NumPy from a seed:

* eval-mode forward for every ``trunk_mode`` ('none' as shipped,
  'per_task' with non-identity detection and occupancy grids, 'shared'):
  head maps, occupancy logits, BEV and depth within 1e-3 of max|ref|, and
  the occupancy argmax equal (BatchNorm biases +4, scales near 1);
* the weight bridge round-trips every leaf bit for bit;
* the decode of JAX's head maps: every anchor decoded, and rotated NMS of
  JAX's candidates keeping JAX's rows;
* ``make_predict_fn_generic`` returns the occupancy argmax beside the
  boxes;
* one train step ('none') in f64 in both packages, anchor + depth +
  occupancy losses: the loss within 1e-6 and every gradient leaf within
  1e-5 of its max|ref| (JAX's gradient jitted; it agrees with the eager
  one here);
* ``configs/bevfusion_occ.py`` builds at full width.

``tests/test_torch_port_mtl_trunks.py`` holds the train step of the
other two trunk modes.
"""

import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg,
    anchor_head_decode_candidates as jax_decode_candidates,
    anchor_head_get_bboxes as jax_get_bboxes)
from omnihd_scenes_tpu.models.mtl import BEVFusionMTL as JaxBEVFusionMTL
from omnihd_scenes_tpu.models.mtl import MTLConfig as JaxMTLConfig
from omnihd_scenes_tpu.train.builder import (
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu_torch import config as port_config
from omnihd_scenes_tpu_torch.models.anchor_head import decode_at
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL
from omnihd_scenes_tpu_torch.models.occ_head import BEVOCCHead2D
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                   make_loss_fn_generic,
                                                   make_predict_fn_generic)
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.weights import (flax_to_torch,
                                             flax_tree_to_torch,
                                             load_state_dict, torch_to_flax)
from tests.test_torch_port_pointpillars import (assert_close_gain,
                                                assert_gradients_match,
                                                assert_kept_rows_match,
                                                condition)
from tests.test_torch_port_train import JAX_TRAIN_CFG, train_batch
from tests.test_torch_port_weights import (flat_paths, random_variables,
                                           to_port_config)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_L, _P = JAX_TRAIN_CFG.lss, JAX_TRAIN_CFG.pillars
JAX_NARROW_CFG = dataclasses.replace(
    JAX_TRAIN_CFG, resnet_depth=18, imc=64, lic=96,
    lss=dataclasses.replace(_L, inputC=64, camC=32, outC=64, grid=1.0),
    pillars=dataclasses.replace(_P, voxel_size=(0.5, 0.5, 8.0),
                                bev_hw=(32, 32), max_voxels=1024,
                                pfn_channels=(32,),
                                second_channels=(32, 64, 64),
                                fpn_channels=(32, 32, 32)))
PORT_NARROW_CFG = to_port_config(JAX_NARROW_CFG)
DEPTH_RANGE = _L.camera_depth_range
OCC_DZ = 4
BEV = 16
BEV_GRID = ((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0))
# 'per_task' crops: detection shifted by half a cell (edge taps outside
# the map), occupancy at 0.5 m over a 12 x 8 m window (an upsampling
# crop).
CASES = {
    'none': {},
    'per_task': dict(grid_conf=BEV_GRID,
                     det_grid_conf=((-7.5, 8.5, 1.0), (-8.5, 7.5, 1.0)),
                     occ_grid_conf=((-6.0, 6.0, 0.5), (-4.0, 4.0, 0.5))),
    'shared': {},
}
INPUT_KEYS = ('points', 'points_mask', 'imgs', 'img2lidar_rots',
              'img2lidar_trans')


def configs(mode, crops=True):
    kw = dict(occ_dz=OCC_DZ, trunk_mode=mode, **(CASES[mode] if crops
                                                  else {}))
    return (JaxMTLConfig(fusion=JAX_NARROW_CFG, **kw),
            port_config.MTLConfig(fusion=PORT_NARROW_CFG, **kw))


def mtl_batch():
    """``train_batch()`` plus ``gt_occ`` (2, 16, 16, 4): a quarter of the
    voxels occupied over classes 1-7 (8-11 absent), a tenth unknown."""
    batch = train_batch()
    rng = np.random.RandomState(17)
    shape = (2, BEV, BEV, OCC_DZ)
    u = rng.uniform(size=shape)
    occ = np.zeros(shape, np.int32)
    occ[u < 0.25] = rng.randint(1, 8, int((u < 0.25).sum()))
    occ[(u >= 0.25) & (u < 0.35)] = 255
    batch['gt_occ'] = occ
    return batch


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(
        a).dtype == np.float32 else np.asarray(a), tree)


def f64_steps(jax_model, model, mtype, variables, batch, port_cfg):
    """((loss, aux, gradients) of JAX, the same of the port), both in f64,
    gradients in torch names."""
    anchors = JAX_NARROW_CFG.pillars.anchors()
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(
        jax_model, mtype, anchors, camera_depth_range=DEPTH_RANGE),
        has_aux=True))
    with jax.enable_x64(True):
        (loss, (aux, _)), grads = grad_fn(*_f64(
            (variables['params'], variables['batch_stats'], batch)))
        want = (float(loss), {k: float(v) for k, v in aux.items()},
                {k: v.double() for k, v in flax_tree_to_torch(
                    jax.tree.map(np.asarray, grads), port_cfg,
                    'params').items()})
    load_state_dict(model, flax_to_torch(variables, port_cfg))
    model = model.double().train()
    loss_fn = make_loss_fn_generic(model, mtype, anchors,
                                   camera_depth_range=DEPTH_RANGE)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch = {k: v.double() if v.is_floating_point() else v
               for k, v in t_batch.items()}
    loss, aux = loss_fn(model, None, t_batch)
    loss.backward()
    got = (loss.item(), {k: v.item() for k, v in aux.items()},
           {k: p.grad.double() for k, p in model.named_parameters()})
    return want, got


def assert_steps_match(want, got):
    (j_loss, j_aux, j_grads), (p_loss, p_aux, p_grads) = want, got
    assert abs(p_loss - j_loss) <= 1e-6 * abs(j_loss)
    assert set(p_aux) == set(j_aux)
    for k, v in j_aux.items():
        assert abs(p_aux[k] - v) <= 1e-6 * max(abs(v), 1e-9), k
    assert_gradients_match(p_grads, j_grads)


@functools.lru_cache(maxsize=None)
def forward_case(mode):
    """JAX's and the port's eval-mode forward on one trunk mode (cached
    per process; treat as read-only)."""
    jcfg, pcfg = configs(mode)
    batch = mtl_batch()
    inputs = [batch[k] for k in INPUT_KEYS]
    jax_model = JaxBEVFusionMTL(jcfg)
    variables = condition(random_variables(jax_model, *inputs, train=False))
    out = jax.jit(lambda v, *a: jax_model.apply(v, *a, train=False))(
        variables, *inputs)
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}
    model = BEVFusionMTL(pcfg)
    load_state_dict(model, flax_to_torch(variables, pcfg))
    model.eval()
    with torch.no_grad():
        port_out = {k: v.numpy() for k, v in model(
            *(torch.from_numpy(x) for x in inputs)).items()
            if v is not None}
    return dict(mode=mode, jcfg=jcfg, pcfg=pcfg, batch=batch,
                variables=variables, out=out, port_out=port_out,
                model=model)


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
    return forward_case(request.param)


@pytest.mark.parametrize('key', ['cls_score', 'bbox_pred', 'dir_pred',
                                 'occ_logits', 'bev', 'depth'])
def test_forward_maps(case, key):
    assert_close_gain(case['port_out'][key], case['out'][key])


def test_occupancy_shape_and_argmax(case):
    want = case['out']['occ_logits']
    dx, dy = (24, 16) if case['mode'] == 'per_task' else (BEV, BEV)
    assert want.shape == (2, dx, dy, OCC_DZ, 12)
    np.testing.assert_array_equal(case['port_out']['occ_logits'].argmax(-1),
                                  want.argmax(-1))


def test_weight_bridge_round_trips(case):
    variables, pcfg = case['variables'], case['pcfg']
    back = flat_paths(torch_to_flax(flax_to_torch(variables, pcfg), pcfg))
    want = flat_paths(variables)
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    names = set(dict(case['model'].named_parameters()))
    assert ('det_head.conv_cls.weight' in names) == (case['mode'] != 'none')
    assert ('fusion.head.conv_cls.weight' in names) == (case['mode']
                                                         == 'none')


def test_predict_returns_the_occupancy_argmax(case):
    model, batch = case['model'], case['batch']
    anchors = JAX_NARROW_CFG.pillars.anchors()
    dets, occ = make_predict_fn_generic(model, 'bevfusion_mtl', anchors)(
        model, {k: batch[k] for k in INPUT_KEYS})
    assert len(dets) == 4 and dets[0].shape == (2, 500, 9)
    np.testing.assert_array_equal(occ.numpy(),
                                  case['out']['occ_logits'].argmax(-1))


def assert_decode_matches(out):
    """Every anchor of sample 0 decoded by the port from JAX's head maps,
    matched to JAX's candidate rows as multisets within 1e-4; rotated NMS
    of JAX's candidates keeps JAX's rows
    (``tests/test_torch_port_lss_camera.py``'s rule).  Random weights
    saturate the head, so its maps are first rescaled to at most 2 in
    magnitude (the same maps on both sides): the decoded sizes stay finite
    and the scores spread."""
    out = {k: (np.asarray(out[k]) / np.abs(out[k]).max() * 2).astype(
        np.float32) for k in ('cls_score', 'bbox_pred', 'dir_pred')}
    anchors = JAX_NARROW_CFG.pillars.anchors()
    n = anchors.reshape(-1, 9).shape[0]
    dcfg = JaxDecodeCfg(score_thr=0.3, nms_pre=n)
    jax_dets = jax.jit(jax.vmap(lambda c, b, d: jax_get_bboxes(
        c, b, d, anchors, dcfg)))(out['cls_score'], out['bbox_pred'],
                                  out['dir_pred'])
    maps = [out[k][0] for k in ('cls_score', 'bbox_pred', 'dir_pred')]
    cand = [np.asarray(c) for c in jax.jit(
        lambda *m: jax_decode_candidates(*m, anchors, dcfg))(*maps)]
    assert len(cand[0]) == n
    got = [t.numpy() for t in decode_at(
        *(torch.from_numpy(m) for m in maps), torch.from_numpy(anchors),
        torch.arange(n))]
    a, b = np.concatenate(cand, -1), np.concatenate(got, -1)
    for x, y in ((a, b), (b, a)):        # each row's nearest, in chunks
        nearest = max(float(np.abs(x[i:i + 256, None] - y[None]).max(
            -1).min(1).max()) for i in range(0, n, 256))
        assert nearest < 1e-4
    port_dets = multiclass_nms_rotated(
        *(torch.from_numpy(c)[None] for c in cand), dcfg.score_thr,
        dcfg.nms_thr, dcfg.max_num)
    assert_kept_rows_match(port_dets, jax_dets, 1)


def test_decode_of_the_same_head_maps():
    """The decode of the shipped trunk mode's head maps."""
    assert_decode_matches(forward_case('none')['out'])


@pytest.fixture(scope='module')
def step_none():
    jcfg, pcfg = configs('none')
    batch = mtl_batch()
    inputs = [batch[k] for k in INPUT_KEYS]
    jax_model = JaxBEVFusionMTL(jcfg)
    variables = condition(random_variables(jax_model, *inputs, train=False))
    return f64_steps(jax_model, BEVFusionMTL(pcfg), 'bevfusion_mtl',
                     variables, batch, pcfg)


def test_f64_train_step(step_none):
    want, got = step_none
    assert {'loss_occ', 'loss_ssc', 'loss_depth'} <= set(want[1])
    assert_steps_match(want, got)
    # The occupancy loss reached the head and, through it, the trunk.
    assert float(got[2]['occ_head.fc2.weight'].abs().max()) > 0
    assert float(got[2]['fusion.fuse.conv.weight'].abs().max()) > 0


def test_bevfusion_occ_builds_at_full_width():
    """``configs/bevfusion_occ.py``: the shipped BEVFusion trunk (R50,
    DepthNet, LSS 16x160x240, sorted pillars) with 'none' trunks and the
    2D occupancy head on the 384-channel fused BEV, 12 classes x 16 z
    bins; ``task_weights`` carried, not applied."""
    model, mtype = build_model_from_cfg(Config.fromfile(
        str(ROOT / 'configs/bevfusion_occ.py')))
    cfg = model.cfg
    assert mtype == 'bevfusion_mtl' and isinstance(model, BEVFusionMTL)
    assert (cfg.occ_classes, cfg.occ_dz, cfg.task_weights,
            cfg.trunk_mode) == (12, 16, (1.0, 1.0), 'none')
    assert cfg.fusion == port_config.BEVFusionConfig()
    head = model.occ_head
    assert isinstance(head, BEVOCCHead2D)
    assert head.conv.in_channels == 384 and head.fc2.out_features == 12 * 16
    assert cfg.fusion.lss.bev_nx == (240, 160, 16)
    assert model.fusion.head is not None
