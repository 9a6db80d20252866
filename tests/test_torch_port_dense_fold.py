"""The pillar stream's newly ported options against the JAX package on
the CPU, f32, weights and points made by NumPy from a seed.

The BN-folded dense pillar encoder (``pillar_impl='dense_fold'``, JAX
``_FoldedPFN``), on a 16x16 pillar grid, batch 2:

* eval mode, one PFN layer, with and without the radar velocity / SNR
  offsets: the canvas within ``TOL`` of max|ref| of JAX's folded encoder
  and of the port's own dense path on the same weights (the fold is exact
  up to reassociation); the frozen BN planted with negative, zero and
  positive scales, so every branch of ``sign(g)`` runs; cells no point
  reaches, masked points and points out of range are in the batch, and
  empty cells are exactly 0;
* train mode computes the dense path, as JAX's gate does: the folded
  encoder's canvas and running statistics equal the dense encoder's bit
  for bit, and JAX's (``train=True``) within ``TOL``;
* two PFN layers compute the dense path in eval mode too.

The SECONDFPN block's fractional stride 1/s (an s x s conv at stride s
with flax ``'SAME'`` padding, the high side padded first) at odd and even
sizes, and SECONDFPN with strides (1/2, 1, 2): within ``TOL`` of max|ref|
of JAX's, the bridge naming its conv ``Conv_0``.

BEVFusion without the camera stream (``camera_stream=False``): the mini
fusion configuration's pillar stream and head (no ResNet, FPNC or LSS in
the model or the bridge), eval-mode head maps within 1e-4 of max|ref| of
JAX's; it serves through ``Predictor`` and takes a train step on a batch
without images (finite loss, every parameter with a gradient).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu.models.layers import (
    DeconvBNReLU as JaxDeconvBNReLU)
from omnihd_scenes_tpu.models.pillar_encoders import (
    DensePillarEncoder as JaxDensePillarEncoder)
from omnihd_scenes_tpu.models.second import SECONDFPN as JaxSECONDFPN
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.layers import DeconvBNReLU
from omnihd_scenes_tpu_torch.models.pillar_encoders import DensePillarEncoder
from omnihd_scenes_tpu_torch.models.second import SECONDFPN
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
from omnihd_scenes_tpu_torch.weights import (flax_to_torch,
                                             load_state_dict, name_map,
                                             pointpillars_name_map)
from tests.test_torch_port_weights import (JAX_MINI_CFG, mini_inputs,
                                           random_variables, to_port_config)

torch.set_num_threads(1)

TOL = 1e-5
PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 5.0)
VOXEL = (1.0, 1.0, 8.0)
GRID = (16, 16)


def points(seed=0, b=2, n=300):
    """Points over the left half of the grid (the right half stays empty),
    a few out of range and the last rows masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7.5, 7.5, (b, n, 8)).astype(np.float32)
    pts[..., 0] = rng.uniform(-7.5, -0.5, (b, n))
    pts[..., 2] = rng.uniform(-2.0, 4.0, (b, n))
    pts[:, :10, 2] = 9.0                                   # out of range
    mask = np.ones((b, n), bool)
    mask[:, -20:] = False
    return pts, mask


def jax_variables(channels, d_in, seed=0):
    """Random PFN weights; the BN's scale negative on a third of the
    channels, zero on two, positive on the rest."""
    rng = np.random.RandomState(seed)
    variables = {'params': {}, 'batch_stats': {}}
    for i, ch in enumerate(channels):
        scale = rng.uniform(0.5, 1.5, ch).astype(np.float32)
        scale[::3] *= -1
        scale[1:3] = 0.0
        variables['params'][f'PFNLayer_{i}'] = {
            'Dense_0': {'kernel': rng.randn(d_in, ch).astype(np.float32)
                        / np.sqrt(d_in)},
            'BatchNorm_0': {'scale': scale,
                            'bias': rng.randn(ch).astype(np.float32)}}
        variables['batch_stats'][f'PFNLayer_{i}'] = {'BatchNorm_0': {
            'mean': rng.randn(ch).astype(np.float32) * 0.3,
            'var': rng.uniform(0.5, 2.0, ch).astype(np.float32)}}
        d_in = 2 * ch
    return variables


def port_encoder(variables, channels, vsnr, fold_bn):
    enc = DensePillarEncoder(8, channels, VOXEL, PC_RANGE, GRID, vsnr,
                             fold_bn=fold_bn)
    with torch.no_grad():
        for i, layer in enumerate(enc.pfn):
            p = variables['params'][f'PFNLayer_{i}']
            s = variables['batch_stats'][f'PFNLayer_{i}']['BatchNorm_0']
            layer.linear.weight.copy_(torch.from_numpy(
                p['Dense_0']['kernel'].T.copy()))
            layer.bn.weight.copy_(torch.from_numpy(p['BatchNorm_0']['scale']))
            layer.bn.bias.copy_(torch.from_numpy(p['BatchNorm_0']['bias']))
            layer.bn.running_mean.copy_(torch.from_numpy(s['mean']))
            layer.bn.running_var.copy_(torch.from_numpy(s['var']))
    return enc


def jax_canvas(variables, channels, vsnr, fold_bn, train, pts, mask):
    enc = JaxDensePillarEncoder(
        feat_channels=channels, voxel_size=VOXEL,
        point_cloud_range=PC_RANGE, grid_hw=GRID,
        with_velocity_snr_center=vsnr, fold_bn=fold_bn)
    out = jax.jit(lambda v, p, m: enc.apply(
        v, p, m, train, mutable=['batch_stats'] if train else False))(
            variables, pts, mask)
    return np.asarray(out[0] if train else out)


def port_canvas(enc, pts, mask):
    with torch.no_grad():
        out = enc(torch.from_numpy(pts), torch.from_numpy(mask))
    return out.permute(0, 2, 3, 1).numpy()


def assert_close(got, want, tol=TOL):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize('vsnr', [False, True], ids=['radar', 'vsnr'])
def test_fold_matches_jax_and_the_dense_path(vsnr):
    channels = (64,)
    variables = jax_variables(channels, 17 if vsnr else 13)
    pts, mask = points()
    want = jax_canvas(variables, channels, vsnr, True, False, pts, mask)
    fold = port_encoder(variables, channels, vsnr, True).eval()
    got = port_canvas(fold, pts, mask)
    dense = port_canvas(port_encoder(variables, channels, vsnr, False).eval(),
                        pts, mask)
    assert got.shape == want.shape == (2, *GRID, 64)
    assert_close(got, want)
    assert_close(got, dense)
    # The empty right half is 0, and g = 0 channels are relu(b) wherever a
    # point landed.
    assert (got[:, :, 8:] == 0).all() and (got[:, :, :7] != 0).any()
    bias = variables['params']['PFNLayer_0']['BatchNorm_0']['bias']
    hit = np.abs(got).sum(-1) > 0
    const = np.maximum(bias[1:3], 0.0)
    np.testing.assert_allclose(got[hit][:, 1:3],
                               np.broadcast_to(const, (hit.sum(), 2)),
                               rtol=0, atol=1e-6)


def test_train_mode_computes_the_dense_path():
    channels = (64,)
    variables = jax_variables(channels, 13, seed=1)
    pts, mask = points(seed=1)
    fold = port_encoder(variables, channels, False, True).train()
    dense = port_encoder(variables, channels, False, False).train()
    got, ref = port_canvas(fold, pts, mask), port_canvas(dense, pts, mask)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(fold.pfn[0].bn.buffers(), dense.pfn[0].bn.buffers()):
        assert torch.equal(a, b)
    assert not torch.equal(fold.pfn[0].bn.running_mean, torch.from_numpy(
        variables['batch_stats']['PFNLayer_0']['BatchNorm_0']['mean']))
    assert_close(got, jax_canvas(variables, channels, False, True, True, pts,
                                 mask))


def test_two_layers_compute_the_dense_path():
    channels = (32, 64)
    variables = jax_variables(channels, 13, seed=2)
    pts, mask = points(seed=2)
    got = port_canvas(port_encoder(variables, channels, False, True).eval(),
                      pts, mask)
    ref = port_canvas(port_encoder(variables, channels, False, False).eval(),
                      pts, mask)
    np.testing.assert_array_equal(got, ref)
    assert_close(got, jax_canvas(variables, channels, False, True, False,
                                 pts, mask))


def _block_state_dict(variables, prefix=''):
    """A ConvBNReLU-style block's torch state from its flax variables."""
    p, st = variables['params'], variables['batch_stats']
    return {f'{prefix}conv.weight': torch.from_numpy(
                np.asarray(p['Conv_0']['kernel']).transpose(3, 2, 0, 1)
                .copy()),
            f'{prefix}bn.weight': torch.from_numpy(np.asarray(
                p['BatchNorm_0']['scale'])),
            f'{prefix}bn.bias': torch.from_numpy(np.asarray(
                p['BatchNorm_0']['bias'])),
            f'{prefix}bn.running_mean': torch.from_numpy(np.asarray(
                st['BatchNorm_0']['mean'])),
            f'{prefix}bn.running_var': torch.from_numpy(np.asarray(
                st['BatchNorm_0']['var']))}


@pytest.mark.parametrize('s,hw', [(2, (7, 9)), (4, (10, 13)), (2, (8, 6))])
def test_fractional_stride_block_matches_jax(s, hw):
    x = np.random.RandomState(s).randn(2, *hw, 16).astype(np.float32)
    jblock = JaxDeconvBNReLU(8, 1 / s)
    variables = random_variables(jblock, x, train=False)
    want = np.asarray(jax.jit(lambda v, x: jblock.apply(
        v, x, train=False))(variables, x))
    block = DeconvBNReLU(16, 8, 1 / s).eval()
    load_state_dict(block, _block_state_dict(variables))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // s), -(-hw[1] // s), 8)
    assert_close(got, want)


def test_fractional_secondfpn_matches_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(1, 16 // 2 ** i, 16 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((16, 32, 64))]
    strides, chans = (0.5, 1, 2), (8, 8, 8)
    jfpn = JaxSECONDFPN(strides, chans)
    variables = random_variables(jfpn, feats, train=False)
    want = np.asarray(jax.jit(lambda v, f: jfpn.apply(
        v, f, train=False))(variables, feats))
    fpn = SECONDFPN((16, 32, 64), strides, chans).eval()
    sd = _block_state_dict(
        {c: variables[c]['DeconvBNReLU_0'] for c in variables},
        'deblocks.0.')
    for i in (1, 2):
        p = variables['params'][f'DeconvBNReLU_{i}']
        k = np.asarray(p['ConvTranspose_0']['kernel'])
        sd[f'deblocks.{i}.deconv.weight'] = torch.from_numpy(
            k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy())
        for tk, coll, fk in (('weight', 'params', 'scale'),
                             ('bias', 'params', 'bias'),
                             ('running_mean', 'batch_stats', 'mean'),
                             ('running_var', 'batch_stats', 'var')):
            sd[f'deblocks.{i}.bn.{tk}'] = torch.from_numpy(np.asarray(
                variables[coll][f'DeconvBNReLU_{i}']['BatchNorm_0'][fk]))
    load_state_dict(fpn, sd)
    with torch.no_grad():
        got = fpn([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert_close(got.permute(0, 2, 3, 1).numpy(), want)
    pcfg = dataclasses.replace(to_port_config(JAX_MINI_CFG).pillars,
                               fpn_strides=strides)
    assert pointpillars_name_map(pcfg)['second_fpn.deblocks.0.conv.weight'] \
        == ('params', 'SECONDFPN_0', 'DeconvBNReLU_0', 'Conv_0', 'kernel')


@pytest.fixture(scope='module')
def radar_only():
    jcfg = dataclasses.replace(JAX_MINI_CFG, camera_stream=False)
    pcfg = to_port_config(jcfg)
    points, mask, *_ = mini_inputs()
    jmodel = JaxBEVFusion(jcfg)
    variables = random_variables(jmodel, points, mask, train=False)
    want = jax.jit(lambda v, p, m: jmodel.apply(v, p, m, train=False))(
        variables, points, mask)
    return pcfg, variables, (points, mask), {
        k: np.asarray(v) for k, v in want.items() if v is not None}


def test_camera_less_bevfusion_matches_jax(radar_only):
    pcfg, variables, (points, mask), want = radar_only
    assert not [k for k in name_map(pcfg)
                if k.split('.')[0] in ('resnet', 'fpnc', 'lss', 'fuse')]
    model = BEVFusion(pcfg).eval()
    assert not hasattr(model, 'resnet') and model.fuse is None
    load_state_dict(model, flax_to_torch(variables, pcfg))
    with torch.no_grad():
        out = model(torch.from_numpy(points), torch.from_numpy(mask), None,
                    None, None)
    assert out['depth'] is None
    for key in ('cls_score', 'bbox_pred', 'dir_pred', 'bev'):
        assert_close(out[key].numpy(), want[key], 1e-4)


def test_camera_less_bevfusion_serves_and_trains(radar_only):
    pcfg, variables, (points, mask), _ = radar_only
    sd = flax_to_torch(variables, pcfg)
    boxes, scores, labels, valid = Predictor(
        pcfg, sd, device='cpu', dtype=torch.float32)(points, mask, None,
                                                     None, None)
    assert boxes.shape == (1, 500, 9) and bool(torch.isfinite(boxes).all())
    batch = random_train_batch(np.random.RandomState(0), pcfg, 2,
                               n_points=300, max_gt=4)
    assert 'imgs' not in batch and 'depth_gaussian' not in batch
    model = BEVFusion(pcfg).train()
    load_state_dict(model, sd)
    loss, aux = make_loss_fn_generic(model, 'bevfusion',
                                     pcfg.pillars.anchors())(
        model, None, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert bool(torch.isfinite(loss)) and 'loss_depth' not in aux
    assert all(p.grad is not None for p in model.parameters())
