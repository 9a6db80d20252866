"""The LSS camera-only BEVFusion (``configs/lss_camera.py``: no radar
stream, no LC fusion, no SE; the head reads the 256-channel camera BEV)
of the port against the JAX package on the CPU, at the mini configuration
of ``tests/test_full_graph_parity.py`` with a ResNet18 backbone (FPNC,
DepthNet + ASPP at 256 channels, LSS 8x8x4 grid by the plain sampling
path), batch 1 (six cameras), with weights and inputs made by NumPy
from a seed:

* eval-mode forward: the camera BEV, head maps and depth within 1e-3 of
  max|ref|;
* every anchor decoded, matched to JAX's candidates as multisets within
  1e-3, and rotated NMS of JAX's candidates keeping the same rows: with random
  weights 470 of 512 anchors survive, and a pair whose BEV IoU sits
  within a rounding of the 0.2 threshold can flip one kept box, so the
  end-to-end rows are not compared;
* one training step (anchor losses + the KLD depth loss) in f64 in both
  packages: the loss within 1e-6 and every gradient leaf within 1e-5 of
  its max|ref|, on conditioned weights and on the weights as drawn;
* the weight bridge round-trips bit for bit, with no pillar, ``fuse`` or
  ``se`` keys;
* ``build_model_from_cfg`` builds it from ``configs/lss_camera.py``.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg,
    anchor_head_decode_candidates as jax_decode_candidates,
    anchor_head_get_bboxes as jax_get_bboxes)
from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu_torch.models.anchor_head import decode_at
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, load_state_dict,
                                             name_map, torch_to_flax)
from tests.test_torch_port_pointpillars import (assert_close_gain,
                                                assert_gradients_match,
                                                assert_kept_rows_match,
                                                condition, jax_f64_step,
                                                port_f64_step)
from tests.test_torch_port_train import JAX_TRAIN_CFG, train_batch
from tests.test_torch_port_weights import (flat_paths, random_variables,
                                           to_port_config)

torch.set_num_threads(1)

# ResNet18 in place of the mini's ResNet50 keeps the file's f64 steps
# short; the rest of the camera trunk is at production widths.
JAX_CAM_CFG = dataclasses.replace(JAX_TRAIN_CFG, radar_stream=False,
                                  lc_fusion=False, se=False, resnet_depth=18)
PORT_CAM_CFG = to_port_config(JAX_CAM_CFG)
CAMERA_KEYS = ('imgs', 'img2lidar_rots', 'img2lidar_trans')
ROOT = pathlib.Path(__file__).resolve().parents[1]


def camera_batch():
    """The first sample of ``train_batch()``, without its radar points."""
    return {k: v[:1] for k, v in train_batch().items()
            if k not in ('points', 'points_mask')}


@pytest.fixture(scope='module')
def camera():
    batch = camera_batch()
    imgs, rots, trans = (batch[k] for k in CAMERA_KEYS)
    jax_model = JaxBEVFusion(JAX_CAM_CFG)
    variables = random_variables(jax_model, None, None, imgs, rots, trans,
                                 train=False)
    out = jax.jit(lambda v, i, r, t: jax_model.apply(
        v, None, None, i, r, t, train=False))(variables, imgs, rots, trans)
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}
    anchors = JAX_CAM_CFG.pillars.anchors()
    dcfg = JaxDecodeCfg(score_thr=0.3)
    jax_dets = jax.jit(jax.vmap(lambda c, b, d: jax_get_bboxes(
        c, b, d, anchors, dcfg)))(out['cls_score'], out['bbox_pred'],
                                  out['dir_pred'])

    model = BEVFusion(PORT_CAM_CFG)
    load_state_dict(model, flax_to_torch(variables, PORT_CAM_CFG))
    model.eval()
    with torch.no_grad():
        port_out = model(None, None, *(torch.from_numpy(batch[k])
                                       for k in CAMERA_KEYS))
    maps = [out[k][0] for k in ('cls_score', 'bbox_pred', 'dir_pred')]
    cand = [np.asarray(c) for c in jax.jit(
        lambda *m: jax_decode_candidates(*m, anchors, dcfg))(*maps)]
    n_anchors = anchors.reshape(-1, 9).shape[0]
    assert len(cand[0]) == n_anchors           # every anchor a candidate
    got_cand = [t.numpy() for t in decode_at(
        *(torch.from_numpy(m) for m in maps), torch.from_numpy(anchors),
        torch.arange(n_anchors))]
    port_dets = multiclass_nms_rotated(
        *(torch.from_numpy(c)[None] for c in cand), dcfg.score_thr,
        dcfg.nms_thr, dcfg.max_num)

    steps = {}
    for name, v in (('conditioned', condition(variables)),
                    ('drawn', variables)):
        steps[name] = (
            jax_f64_step(jax_model, 'lss', anchors, v, batch, PORT_CAM_CFG),
            port_f64_step(BEVFusion(PORT_CAM_CFG), 'lss', anchors, v, batch,
                          PORT_CAM_CFG))
    return dict(variables=variables, out=out, jax_dets=jax_dets,
                cand=cand, got_cand=got_cand, anchors=anchors,
                port_out={k: v.numpy() for k, v in port_out.items()},
                port_dets=port_dets, steps=steps)


@pytest.mark.parametrize('key', ['bev', 'cls_score', 'bbox_pred', 'dir_pred',
                                 'depth', 'depth_logits'])
def test_forward_maps(camera, key):
    assert_close_gain(camera['port_out'][key], camera['out'][key])


def test_head_reads_the_camera_bev(camera):
    assert camera['out']['bev'].shape[-1] == JAX_CAM_CFG.lss.outC == 256


def test_decoded_candidates(camera):
    """Every anchor decoded: JAX's candidate rows (box, class scores) and
    the port's, matched as multisets (top-k orders near-tied keys
    differently) within 1e-3, box columns over their gain."""
    rows = []
    an = camera['anchors'].reshape(-1, 9)
    diag = float(np.sqrt(an[:, 3] ** 2 + an[:, 4] ** 2).max())
    for boxes, scores in (camera['got_cand'], camera['cand']):
        gain = np.array([diag, diag, an[:, 5].max(), *an[:, 3:6].max(0),
                         1.0, diag, diag])
        rows.append(np.concatenate([boxes / np.maximum(gain, 1.0), scores],
                                   -1))
    d = np.abs(rows[0][:, None] - rows[1][None]).max(-1)
    assert float(d.min(1).max()) < 1e-3 and float(d.min(0).max()) < 1e-3


def test_nms_keeps_the_same_rows(camera):
    assert_kept_rows_match(camera['port_dets'], camera['jax_dets'], 1)


@pytest.mark.parametrize('weights', ['conditioned', 'drawn'])
def test_f64_train_step_gradients(camera, weights):
    (j_loss, j_grads), (p_loss, p_grads, below) = camera['steps'][weights]
    assert abs(p_loss - j_loss) <= 1e-6 * abs(j_loss)
    assert_gradients_match(p_grads, j_grads)
    # The view transform's backward reached DepthNet's depth head.
    assert float(p_grads['lss.depthnet.depth_conv.weight'].abs().max()) > 0
    if weights == 'drawn':
        assert below > 0.2, below


def test_weight_bridge_round_trips(camera):
    variables = camera['variables']
    assert not {'PillarFeatureNet_0', 'SECOND_0', 'ConvBNReLU_0',
                'SEBlock_0'} & set(variables['params'])
    back = flat_paths(torch_to_flax(flax_to_torch(variables, PORT_CAM_CFG),
                                    PORT_CAM_CFG))
    want = flat_paths(variables)
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    keys = set(name_map(PORT_CAM_CFG))
    assert not any(k.startswith(('pillar_encoder', 'second', 'fuse', 'se.'))
                   for k in keys)


def test_built_from_the_shipped_config():
    """``configs/lss_camera.py`` builds the camera-only model at full
    width: 256 head channels on the 160x240 grid, anchors of the same
    grid (no resize)."""
    model, mtype = build_model_from_cfg(Config.fromfile(
        str(ROOT / 'configs/lss_camera.py')))
    cfg = model.cfg
    assert mtype == 'lss' and not cfg.radar_stream and not cfg.lc_fusion
    assert model.fuse is None and model.se is None
    assert model.head.conv_cls.in_channels == cfg.head_channels == 256
    nx, ny, _ = cfg.lss.bev_nx
    assert (ny, nx) == cfg.pillars.head_hw == (160, 240)


def test_radar_stream_without_points_is_an_error():
    model = BEVFusion(dataclasses.replace(PORT_CAM_CFG, radar_stream=True,
                                          lc_fusion=True))
    with pytest.raises(ValueError, match='needs points'):
        model(None, None, *(torch.from_numpy(v) for k, v in
                            camera_batch().items() if k in CAMERA_KEYS))
