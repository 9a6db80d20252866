"""The space-to-depth stem (``stem_s2d``, JAX ``resnet.py:_S2DStem``) of
the port against the JAX package on the CPU:

* ``space_to_depth`` (torch) and ``space_to_depth_np`` equal JAX's packing
  element for element, channel ``(qy * 2 + qx) * C + c`` holding pixel
  (2i + qy, 2j + qx, c), through the NHWC -> channels_last move too;
* ``S2DStem`` on the packed image equals the standard 7x7 stride-2 stem on
  the unpacked one within 1e-12 of max|ref| in f64, at even and odd
  packed sizes, and keeps the standard stem's (64, 3, 7, 7) weight;
* a ResNet18 with the s2d stem on JAX's weights: f32 stage outputs within
  1e-4 of max|ref| of JAX's s2d ResNet (eval);
* its int8 tier against JAX's: the quant state key for key (the stem's
  ``act_amax`` only, every other conv's ``act_amax``, ``w8`` and
  ``w_scale``), ``act_amax`` within 1e-5 relative, ``w8`` / ``w_scale``
  equal; the int8 outputs within 1e-3 of max|ref| of JAX's int8 s2d
  outputs on JAX's state, closer to them than to JAX's int8 standard-stem
  outputs (the s2d stem stays float, the standard one is int8: a
  different function, each held to its own counterpart);
* a BEVFusion ``Predictor`` with ``stem_s2d`` (the mini configuration,
  f32) on packed images equals the standard one on the unpacked images
  within 1e-5 of max|ref|, and refuses unpacked images.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omnihd_scenes_tpu.models import quant as jquant
from omnihd_scenes_tpu.models.resnet import ResNet as JaxResNet
from omnihd_scenes_tpu.models.resnet import (
    space_to_depth as jax_space_to_depth,
    space_to_depth_np as jax_space_to_depth_np)
from omnihd_scenes_tpu_torch.models.quant import (calibrate_model,
                                                  load_quant_state, set_mode)
from omnihd_scenes_tpu_torch.models.resnet import (ResNet, S2DStem,
                                                   space_to_depth,
                                                   space_to_depth_np)
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.weights import (_flax_to_torch_layout,
                                             flax_to_torch, resnet_name_map)
from tests.test_torch_port_weights import (PORT_MINI_CFG, mini_inputs,
                                           mini_variables, random_variables)

torch.set_num_threads(1)

OUT = (0, 1, 2, 3)
INT8_TOL = 1e-3


@pytest.fixture(scope='module')
def img():
    return np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)


def test_packing_matches_jax(img):
    want = jax_space_to_depth_np(img)
    np.testing.assert_array_equal(np.asarray(jax_space_to_depth(
        jnp.asarray(img))), want)
    np.testing.assert_array_equal(space_to_depth_np(img), want)
    got = space_to_depth(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    i, j, qy, qx, c = 5, 7, 1, 0, 2
    assert want[0, i, j, (qy * 2 + qx) * 3 + c] == img[0, 2 * i + qy,
                                                       2 * j + qx, c]
    # NHWC viewed as NCHW (channels_last), as the model reads images.
    nchw = got.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    assert nchw[0, (qy * 2 + qx) * 3 + c, i, j] == img[0, 2 * i + qy,
                                                       2 * j + qx, c]
    with pytest.raises(ValueError, match='even'):
        space_to_depth_np(img[:, :63])


@pytest.mark.parametrize('hw', [(64, 96), (18, 26)])
def test_stem_equals_the_standard_stem(hw):
    torch.manual_seed(0)
    stem = S2DStem(3, 64).double()
    assert stem.weight.shape == (64, 3, 7, 7)
    x = torch.randn(2, 3, *hw, dtype=torch.float64)
    want = F.conv2d(x, stem.weight.detach(), stride=2, padding=3)
    packed = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = stem(packed)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _resnet_sd(variables):
    sd = {}
    for key, path in resnet_name_map(18).items():
        v = variables[path[0]]
        for k in path[1:]:
            v = v[k]
        sd[key] = torch.from_numpy(_flax_to_torch_layout(
            np.asarray(v, np.float32), path).copy())
    return sd


def _quant_to_torch(quant):
    """JAX ResNet ``quant`` collection -> the port's quant-state keys."""
    modules = {path[1:-1]: key[:-len('.weight')]
               for key, path in resnet_name_map(18).items()
               if path[-1] == 'kernel'}
    out = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                v = np.asarray(v)
                if k == 'w8':
                    v = v.transpose(3, 2, 0, 1)
                out[f'{modules[prefix]}.{k}'] = torch.from_numpy(v.copy())

    walk(quant)
    return out


def _jax_quant_run(model, variables, x, mode, quant=None):
    try:
        jquant.set_mode(mode)
        v = dict(variables, **({'quant': quant} if quant is not None else {}))
        if mode in ('calib', 'freeze'):
            out = jax.jit(lambda v, x: model.apply(
                v, x, train=False, mutable=['quant'])[1]['quant'])(v, x)
            return jax.tree.map(np.asarray, out)
        return [np.asarray(o) for o in jax.jit(lambda v, x: model.apply(
            v, x, train=False))(v, x)]
    finally:
        jquant.set_mode('off')


@pytest.fixture(scope='module')
def resnet_case(img):
    packed = jax_space_to_depth_np(img)
    jax_s2d = JaxResNet(depth=18, out_indices=OUT, stem_s2d=True)
    jax_std = JaxResNet(depth=18, out_indices=OUT)
    variables = random_variables(jax_s2d, packed, train=False)
    want = [np.asarray(o) for o in jax.jit(lambda v, x: jax_s2d.apply(
        v, x, train=False))(variables, packed)]
    quant = _jax_quant_run(jax_s2d, variables, packed, 'calib')
    quant = _jax_quant_run(jax_s2d, variables, packed, 'freeze', quant)
    int8 = _jax_quant_run(jax_s2d, variables, packed, 'int8', quant)
    std_quant = _jax_quant_run(jax_std, variables, img, 'calib')
    int8_std = _jax_quant_run(jax_std, variables, img, 'int8', std_quant)

    model = ResNet(18, OUT, frozen_bn=True, stem_s2d=True).eval()
    model.load_state_dict(_resnet_sd(variables), strict=False)
    x = torch.from_numpy(packed).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = [o.permute(0, 2, 3, 1).numpy() for o in model(x)]
    state = calibrate_model(model, model, [x])
    load_quant_state(model, _quant_to_torch(quant))
    set_mode(model, 'int8')
    with torch.no_grad():
        got_int8 = [o.permute(0, 2, 3, 1).numpy() for o in model(x)]
    return dict(float=(got, want), quant=(state, _quant_to_torch(quant)),
                int8=(got_int8, int8, int8_std))


def test_s2d_resnet_matches_jax(resnet_case):
    for got, want in zip(*resnet_case['float']):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-4, err


def test_s2d_quant_state_matches_jax(resnet_case):
    got, want = resnet_case['quant']
    assert set(got) == set(want)
    assert 'conv1.act_amax' in got
    assert 'conv1.w8' not in got and 'conv1.w_scale' not in got
    n_convs = sum(k.endswith('.act_amax') for k in got)
    assert len(got) == 3 * n_convs - 2
    for k in got:
        if k.endswith('.act_amax'):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(got[k], want[k]), k


def test_s2d_int8_matches_jax(resnet_case):
    got, want, want_std = resnet_case['int8']
    for g, w, s in zip(got, want, want_std):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < INT8_TOL, err
        assert np.abs(g - w).max() < np.abs(g - s).max()


def test_s2d_predictor_serves_packed_images():
    sd = flax_to_torch(mini_variables(), PORT_MINI_CFG)
    points, mask, imgs, rots, trans = mini_inputs()
    want = Predictor(PORT_MINI_CFG, sd, device='cpu',
                     dtype=torch.float32).forward(points, mask, imgs, rots,
                                                  trans)
    s2d = Predictor(dataclasses.replace(PORT_MINI_CFG, stem_s2d=True), sd,
                    device='cpu', dtype=torch.float32)
    got = s2d.forward(points, mask, space_to_depth_np(imgs), rots, trans)
    for key in ('bev', 'cls_score', 'bbox_pred', 'dir_pred', 'depth'):
        err = (got[key] - want[key]).abs().max() / want[key].abs().max()
        assert float(err) < 1e-5, (key, float(err))
    with pytest.raises(ValueError, match='12'):
        s2d.forward(points, mask, imgs, rots, trans)
