"""RCFusion (``model_type='rcfusion'``: BEVFusion with the cross-modal
spatial-attention fuser, ``rc_fusion='cross_attention'``) of the port
against the JAX package on the CPU, through the weight bridge, at the
narrow mini configuration of ``tests/test_torch_port_mtl.py``, batch 2,
weights and inputs made by NumPy from a seed:

* eval-mode forward: head maps, the fused BEV and depth within 1e-3 of
  max|ref| (BatchNorm biases +4, scales near 1);
* the weight bridge round-trips every leaf bit for bit, with the fuser's
  ``att_img`` / ``att_radar`` convs and its ConvBNReLU;
* the decode of JAX's head maps (every anchor, rotated NMS keeping JAX's
  rows);
* one train step in f64 (anchor + depth losses): the loss within 1e-6 and
  every gradient leaf within 1e-5 of its max|ref|, the two attention
  convs' included;
* ``configs/rcfusion.py`` builds at full width.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu_torch.models.bevfusion import (BEVFusion,
                                                      CrossModalFusion)
from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, load_state_dict,
                                             torch_to_flax)
from tests.test_torch_port_mtl import (INPUT_KEYS, JAX_NARROW_CFG,
                                       assert_decode_matches,
                                       assert_steps_match, f64_steps)
from tests.test_torch_port_pointpillars import assert_close_gain, condition
from tests.test_torch_port_train import train_batch
from tests.test_torch_port_weights import (flat_paths, random_variables,
                                           to_port_config)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_RC_CFG = dataclasses.replace(JAX_NARROW_CFG, rc_fusion='cross_attention')
PORT_RC_CFG = to_port_config(JAX_RC_CFG)


@pytest.fixture(scope='module')
def rc():
    batch = train_batch()
    inputs = [batch[k] for k in INPUT_KEYS]
    jax_model = JaxBEVFusion(JAX_RC_CFG)
    variables = condition(random_variables(jax_model, *inputs, train=False))
    out = jax.jit(lambda v, *a: jax_model.apply(v, *a, train=False))(
        variables, *inputs)
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}
    model = BEVFusion(PORT_RC_CFG)
    load_state_dict(model, flax_to_torch(variables, PORT_RC_CFG))
    model.eval()
    with torch.no_grad():
        port_out = {k: v.numpy() for k, v in model(
            *(torch.from_numpy(x) for x in inputs)).items()}
    step = f64_steps(jax_model, BEVFusion(PORT_RC_CFG), 'rcfusion',
                     variables, batch, PORT_RC_CFG)
    return dict(variables=variables, out=out, port_out=port_out, step=step,
                model=model)


@pytest.mark.parametrize('key', ['cls_score', 'bbox_pred', 'dir_pred', 'bev',
                                 'depth'])
def test_forward_maps(rc, key):
    assert_close_gain(rc['port_out'][key], rc['out'][key])


def test_weight_bridge_round_trips(rc):
    variables = rc['variables']
    assert {'att_img', 'att_radar', 'ConvBNReLU_0'} == set(
        variables['params']['CrossModalFusion_0'])
    back = flat_paths(torch_to_flax(flax_to_torch(variables, PORT_RC_CFG),
                                    PORT_RC_CFG))
    want = flat_paths(variables)
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    assert isinstance(rc['model'].fuse, CrossModalFusion)


def test_decode_of_the_same_head_maps(rc):
    assert_decode_matches(rc['out'])


def test_f64_train_step(rc):
    want, got = rc['step']
    assert_steps_match(want, got)
    for name in ('fuse.att_img.weight', 'fuse.att_radar.weight'):
        assert float(got[2][name].abs().max()) > 0, name


def test_rcfusion_builds_at_full_width():
    """``configs/rcfusion.py``: the shipped BEVFusion trunk with the
    cross-modal fuser (256 camera + 384 radar channels -> 384), then the
    SE gate and the head."""
    model, mtype = build_model_from_cfg(Config.fromfile(
        str(ROOT / 'configs/rcfusion.py')))
    assert mtype == 'rcfusion' and isinstance(model, BEVFusion)
    assert model.cfg.rc_fusion == 'cross_attention'
    fuse = model.fuse
    assert isinstance(fuse, CrossModalFusion)
    assert fuse.fuse.conv.in_channels == 256 + 384
    assert fuse.fuse.conv.out_channels == 384
    assert fuse.att_img.weight.shape == fuse.att_radar.weight.shape == (
        1, 2, 3, 3)
    assert model.se is not None and model.head is not None
