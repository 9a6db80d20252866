"""DCNv2 (``models/dcn.py:DeformConv``) and the R101-DCN backbone's
``stage_with_dcn`` on the port against the JAX package, on the CPU:

* ``DeformConv`` at stride 1 and 2 within 1e-5 of max|ref| of JAX's, with
  offsets that move taps off the map (the offset conv's bias spread over
  +-3 pixels, its kernel perturbed);
* its f32 gradients (input, kernel, offset conv) within 1e-5 of
  max|ref| of ``jax.grad``'s; the port's f64 gradients against central
  differences on seeded directions (JAX's ``bilinear_sample`` cannot run
  under x64, ROADMAP queue 3 item 10) within 1e-6;
* mmcv's offset layout: an offset on the dy channels alone moves the taps
  by rows, as a plain conv of the input shifted by rows, times sigmoid(0);
* the weight bridge's DCN leaves and ResNet-101's 23-block ``layer3``;
* ``configs/synthetic/bevformer_synth.py``'s model with DCNv2 on stages
  3-4, a stream of three frames against JAX's, as
  ``test_torch_port_bevformer.py::test_forward_stream_three_frames``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from omnihd_scenes_tpu.models.dcn import DeformConv as JaxDeformConv
from omnihd_scenes_tpu.models.bevformer.detector import (
    BEVFormerDetector as JaxDetector)
from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
from omnihd_scenes_tpu_torch.models.dcn import DeformConv
from omnihd_scenes_tpu_torch.models.resnet import ResNet
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, load_state_dict,
                                             name_map, resnet_name_map,
                                             torch_to_flax)
from tests.test_torch_port_bevformer import (CFG, JCFG, NQ, C, _frames,
                                             assert_close, bridged_variables,
                                             jax_variable_shapes)

torch.set_num_threads(1)
TOL = 1e-5
FD_TOL = 1e-6
DCN = (False, False, True, True)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_variables(rng, c_in, c_out, stride, x):
    """JAX's DeformConv variables, perturbed so that offsets and masks
    vary per pixel and some taps leave the map."""
    v = JaxDeformConv(c_out, 3, strides=stride).init(
        jax.random.PRNGKey(0), x.astype(np.float32))['params']
    return {'kernel': np.asarray(v['kernel'], x.dtype),
            'conv_offset': {
                'kernel': rng.normal(0, 0.3, v['conv_offset']['kernel'].shape
                                     ).astype(x.dtype),
                'bias': rng.uniform(-3, 3, v['conv_offset']['bias'].shape
                                    ).astype(x.dtype)}}


def port_module(params, c_in, c_out, stride, dtype=torch.float32):
    m = DeformConv(c_in, c_out, stride)
    sd = {'weight': params['kernel'],
          'conv_offset.weight': params['conv_offset']['kernel'],
          'conv_offset.bias': params['conv_offset']['bias']}
    with torch.no_grad():
        for k, v in sd.items():
            v = np.asarray(v)
            m.get_parameter(k).copy_(t(v.transpose(3, 2, 0, 1) if v.ndim == 4
                                       else v))
    return m.to(dtype)


def case(stride, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 9, 11, 5).astype(dtype)
    return x, jax_variables(rng, 5, 6, stride, x)


@pytest.mark.parametrize('stride', [1, 2])
def test_forward_equals_jax(stride):
    x, params = case(stride)
    want = jax.jit(JaxDeformConv(6, 3, strides=stride).apply)(
        {'params': params}, x)
    m = port_module(params, 5, 6, stride)
    got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, want, TOL)
    # Some taps left the map: their offsets reach past the border.
    off = m.conv_offset(t(x).permute(0, 3, 1, 2))[:, :18]
    assert float(off.detach().abs().max()) > 3.0


@pytest.mark.parametrize('stride', [1, 2])
def test_f32_gradients_equal_jax(stride):
    x, params = case(stride, seed=1)
    cot = np.random.RandomState(2).randn(
        *JaxDeformConv(6, 3, strides=stride).apply(
            {'params': params}, x).shape).astype(np.float32)
    jm = JaxDeformConv(6, 3, strides=stride)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(
        jm.apply({'params': p}, x) * cot), argnums=(0, 1)))(params, x)
    m = port_module(params, 5, 6, stride)
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    (m(xt).permute(0, 2, 3, 1) * t(cot)).sum().backward()
    assert_close(xt.grad.permute(0, 2, 3, 1), gx, TOL)
    assert_close(m.weight.grad.permute(2, 3, 1, 0), gp['kernel'], TOL)
    assert_close(m.conv_offset.weight.grad.permute(2, 3, 1, 0),
                 gp['conv_offset']['kernel'], TOL)
    assert_close(m.conv_offset.bias.grad, gp['conv_offset']['bias'], TOL)


@pytest.mark.parametrize('stride', [1, 2])
def test_f64_gradients_against_central_differences(stride):
    x, params = case(stride, seed=3, dtype=np.float64)
    m = port_module(params, 5, 6, stride, torch.float64)
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    cot = torch.from_numpy(np.random.RandomState(4).randn(
        *m(xt).shape))
    (m(xt) * cot).sum().backward()
    leaves = [xt] + list(m.parameters())
    grads = [leaf.grad.clone() for leaf in leaves]
    rng = np.random.RandomState(5)
    eps = 1e-6
    for _ in range(4):
        dirs = [torch.from_numpy(rng.randn(*leaf.shape)) for leaf in leaves]
        with torch.no_grad():
            def f(sign):
                for leaf, d in zip(leaves, dirs):
                    leaf.add_(sign * eps * d)
                out = float((m(xt) * cot).sum())
                for leaf, d in zip(leaves, dirs):
                    leaf.sub_(sign * eps * d)
                return out
            fd = (f(1.0) - f(-1.0)) / (2 * eps)
        an = float(sum((g * d).sum() for g, d in zip(grads, dirs)))
        assert abs(fd - an) <= FD_TOL * max(1.0, abs(an)), (fd, an)


def test_offsets_use_mmcv_interleaved_layout():
    """Raw channels (dy0, dx0, dy1, dx1, ..., mask0..8): a bias of 1 on
    the dy channels moves every tap one row down, so the output is the
    plain conv with its padding moved from the top to the bottom (taps
    below the image read 0), times sigmoid(0) = 0.5 per tap; on the dx
    channels, the same by columns."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 4, 7, 8).astype(np.float32))
    m = DeformConv(4, 3)
    for channels, pad in ((slice(0, 18, 2), (1, 1, 0, 2)),
                          (slice(1, 18, 2), (0, 2, 1, 1))):
        with torch.no_grad():
            m.conv_offset.bias.zero_()
            m.conv_offset.bias[channels] = 1.0
        want = 0.5 * F.conv2d(F.pad(x, pad), m.weight)
        torch.testing.assert_close(m(x), want, rtol=1e-5, atol=1e-5)


def test_resnet101_dcn_name_map():
    """ResNet-101 with DCN on stages 3-4: 23 + 3 deformable convs, each
    with its kernel and offset conv, the plain convs renumbered around
    them as flax numbers them; every torch key mapped once."""
    pairs = resnet_name_map(101, DCN)
    deform = [k for k, p in pairs.items() if 'DeformConv_0' in p]
    assert len([k for k in deform if k.endswith('conv2.weight')]) == 26
    assert sum(k.startswith('layer3.') for k in deform) == 23 * 3
    assert pairs['layer3.22.conv3.weight'] == ('params', 'Bottleneck_29',
                                               'Conv_1', 'kernel')
    assert pairs['layer3.0.downsample.0.weight'] == (
        'params', 'Bottleneck_7', 'Conv_2', 'kernel')
    assert pairs['layer4.2.conv2.conv_offset.bias'] == (
        'params', 'Bottleneck_32', 'DeformConv_0', 'conv_offset', 'bias')
    model = ResNet(101, (3,), stage_with_dcn=DCN)
    keys = {k for k in model.state_dict() if 'num_batches' not in k}
    assert keys == set(pairs) and len(set(pairs.values())) == len(pairs)
    assert resnet_name_map(101) == resnet_name_map(101, (False,) * 4)


# -- a small BEVFormer with DCN ---------------------------------------------

DCN_CFG = dataclasses.replace(CFG, stage_with_dcn=DCN)
DCN_JCFG = dataclasses.replace(JCFG, stage_with_dcn=DCN)


@pytest.fixture(scope='module')
def dcn_models():
    variables = bridged_variables(DCN_CFG, seed=2)
    rng = np.random.RandomState(7)
    backbone = variables['params']['img_backbone']
    for block in backbone.values():
        for name, mod in block.items() if isinstance(block, dict) else ():
            if name.startswith('DeformConv'):
                off = mod['conv_offset']
                off['bias'] = rng.uniform(-2, 2, off['bias'].shape).astype(
                    np.float32)
    pm = BEVFormerDetector(DCN_CFG)
    load_state_dict(pm, flax_to_torch(variables, DCN_CFG))
    pm.eval()
    jm = JaxDetector(DCN_JCFG)
    stream = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=JaxDetector.forward_stream))
    return dict(jm=jm, v=variables, pm=pm, stream=stream)


def test_dcn_bevformer_round_trip(dcn_models):
    """The bridge covers every leaf of JAX's DCN tree and returns it bit
    for bit."""
    v = dcn_models['v']
    shapes = jax_variable_shapes(dcn_models['jm'])
    flat = jax.tree_util.tree_flatten_with_path
    assert ({jax.tree_util.keystr(p): leaf.shape
             for p, leaf in flat(shapes)[0]}
            == {jax.tree_util.keystr(p): np.shape(leaf)
                for p, leaf in flat(v)[0]})
    assert len(name_map(DCN_CFG)) == len(flat(v)[0])
    back = torch_to_flax(flax_to_torch(v, DCN_CFG), DCN_CFG)
    for path, leaf in flat(v)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_dcn_bevformer_stream_equals_jax(dcn_models):
    imgs, cbs, l2i, has_prev = _frames(seed=8)
    j_prev = np.zeros((NQ, C), np.float32)
    p_prev = torch.zeros(1, NQ, C)
    for i in range(3):
        want = dcn_models['stream'](dcn_models['v'], imgs[i], cbs[i], l2i[i],
                                    j_prev, np.asarray(has_prev[i]))
        with torch.no_grad():
            got = dcn_models['pm'].forward_stream(
                t(imgs[i:i + 1]), t(cbs[i:i + 1]), t(l2i[i:i + 1]), p_prev,
                t(has_prev[i:i + 1]))
        for key in ('bev_embed', 'all_cls_scores', 'all_bbox_preds'):
            assert_close(got[key][0], want[key], 1e-4)
        j_prev, p_prev = want['bev_embed'], got['bev_embed']
