"""Camera trunk of the port against the JAX package, on the mini
BEVFusion's weights: ResNet50 stages, FPNC, DepthNet + ASPP and the 1x1
CamEncode, at production channel widths and reduced spatial size, f32.

Tolerance: 1e-4 of the reference's largest magnitude (f32 convs summed in
another order over up to 2304 terms per output).
"""

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.fpnc import FPNC as JaxFPNC
from omnihd_scenes_tpu.models.lss import CamEncode as JaxCamEncode
from omnihd_scenes_tpu.models.lss import DepthNet as JaxDepthNet
from omnihd_scenes_tpu.models.resnet import ResNet as JaxResNet
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.lss import CamEncode
from omnihd_scenes_tpu_torch.weights import flax_to_torch, load_state_dict
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           mini_inputs, mini_variables,
                                           random_variables)

torch.set_num_threads(1)

TOL = 1e-4


def assert_close_gain(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope='module')
def camera():
    variables = mini_variables()
    model = BEVFusion(PORT_MINI_CFG)
    load_state_dict(model, flax_to_torch(variables, PORT_MINI_CFG))
    model.eval()
    imgs = mini_inputs()[2]
    flat = imgs.reshape((-1,) + imgs.shape[2:])

    def sub(name, tree=None):
        tree = tree or variables
        return {'params': tree['params'][name],
                'batch_stats': tree['batch_stats'].get(name, {})}

    stages = JaxResNet(depth=50, out_indices=(1, 2, 3),
                       frozen_bn=True).apply(sub('ResNet_0'), flat,
                                             train=False)
    stages = [np.asarray(s) for s in stages]
    feat = np.asarray(jax.jit(lambda v, s: JaxFPNC(
        out_channels=256, outC=JAX_MINI_CFG.imc,
        target_hw=JAX_MINI_CFG.lss.feat_hw).apply(v, s, train=False))(
            sub('FPNC_0'), stages))
    lss = sub('LiftSplatShoot_0')
    dn = {'params': lss['params']['DepthNet_0'],
          'batch_stats': lss['batch_stats']['DepthNet_0']}
    lss_cfg = JAX_MINI_CFG.lss
    depthnet = [np.asarray(o) for o in jax.jit(lambda v, x: JaxDepthNet(
        lss_cfg.depth_bins, lss_cfg.camC).apply(v, x, train=False))(dn, feat)]
    return dict(model=model, flat=flat, stages=stages, feat=feat,
                depthnet=depthnet)


def test_resnet_stages(camera):
    with torch.no_grad():
        got = camera['model'].resnet(nchw(camera['flat']))
    assert len(got) == 3
    for g, w in zip(got, camera['stages']):
        assert_close_gain(nhwc(g), w)


def test_fpnc(camera):
    """FPNC on the JAX stage outputs (upsampling only)."""
    with torch.no_grad():
        got = camera['model'].fpnc([nchw(s) for s in camera['stages']])
    assert_close_gain(nhwc(got), camera['feat'])


def test_depthnet_aspp(camera):
    with torch.no_grad():
        ctx, depth, logits = camera['model'].lss.depthnet(
            nchw(camera['feat']))
    want_ctx, want_depth, want_logits = camera['depthnet']
    assert_close_gain(nhwc(ctx), want_ctx)
    assert_close_gain(nhwc(logits), want_logits)
    np.testing.assert_allclose(nhwc(depth), want_depth, atol=1e-5)


def test_cam_encode():
    """The 1x1 CamEncode (``use_depthnet=False``)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 10, 256).astype(np.float32)
    mod = JaxCamEncode(depth_bins=8, cam_channels=64)
    v = random_variables(mod, x)
    feat_j, depth_j = (np.asarray(a) for a in mod.apply(v, x))
    port = CamEncode(256, 8, 64).eval()
    k = v['params']['Conv_0']
    port.conv.weight.data = torch.from_numpy(
        k['kernel'].transpose(3, 2, 0, 1).copy())
    port.conv.bias.data = torch.from_numpy(k['bias'].copy())
    with torch.no_grad():
        feat_t, depth_t = port(nchw(x))
    assert_close_gain(nhwc(feat_t), feat_j)
    np.testing.assert_allclose(nhwc(depth_t), depth_j, atol=1e-6)
