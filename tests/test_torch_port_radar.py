"""Radar stream of the port against the JAX package, f32:
``DensePillarEncoder`` (padded points, out-of-range points, empty cells,
one and two PFN layers, the RadarPillarNet velocity/SNR offsets),
``SECOND`` and ``SECONDFPN`` on the mini BEVFusion's weights."""

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.pillar_encoders import (
    DensePillarEncoder as JaxDensePillarEncoder)
from omnihd_scenes_tpu.models.second import SECOND as JaxSECOND
from omnihd_scenes_tpu.models.second import SECONDFPN as JaxSECONDFPN
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.pillar_encoders import DensePillarEncoder
from omnihd_scenes_tpu_torch.weights import flax_to_torch, load_state_dict
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           mini_variables, random_variables)

torch.set_num_threads(1)

PC = JAX_MINI_CFG.pillars


def _points(seed=1, b=2, n=300):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7, 7, (b, n, 8)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 4, (b, n))
    pts[:, :20, 0] = rng.uniform(8.5, 12, (b, 20))     # out of range in x
    pts[:, 20:30, 2] = 6.0                              # out of range in z
    pts[:, 30:60, :2] = pts[:, 30:31, :2]               # one crowded pillar
    mask = np.ones((b, n), bool)
    mask[:, -40:] = False                               # padding
    pts[:, -40:] = 1e6                                  # garbage in padding
    return pts, mask


@pytest.mark.parametrize('channels,velocity', [((64,), False),
                                               ((32, 64), False),
                                               ((64,), True)],
                         ids=['pfn64', 'pfn32-64', 'radar-pillarnet'])
def test_dense_pillar_encoder(channels, velocity):
    pts, mask = _points()
    jax_mod = JaxDensePillarEncoder(
        feat_channels=channels, voxel_size=PC.voxel_size,
        point_cloud_range=PC.point_cloud_range, grid_hw=PC.bev_hw,
        with_velocity_snr_center=velocity)
    v = random_variables(jax_mod, pts, mask, False)
    want = np.asarray(jax_mod.apply(v, pts, mask, False))

    port = DensePillarEncoder(8, channels, PC.voxel_size,
                              PC.point_cloud_range, PC.bev_hw, velocity)
    sd = {}
    for i in range(len(channels)):
        p, s = v['params'][f'PFNLayer_{i}'], v['batch_stats'][f'PFNLayer_{i}']
        sd.update({
            f'pfn.{i}.linear.weight': p['Dense_0']['kernel'].T,
            f'pfn.{i}.bn.weight': p['BatchNorm_0']['scale'],
            f'pfn.{i}.bn.bias': p['BatchNorm_0']['bias'],
            f'pfn.{i}.bn.running_mean': s['BatchNorm_0']['mean'],
            f'pfn.{i}.bn.running_var': s['BatchNorm_0']['var']})
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in sd.items()}, strict=False)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.shape == (2, channels[-1]) + tuple(PC.bev_hw)
    got = got.permute(0, 2, 3, 1).numpy()
    empty = ~want.any(-1)
    assert empty.mean() > 0.3 and (~empty).sum() > 50
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def radar():
    variables = mini_variables()
    model = BEVFusion(PORT_MINI_CFG)
    load_state_dict(model, flax_to_torch(variables, PORT_MINI_CFG))
    return variables, model.eval()


def _sub(variables, name):
    return {'params': variables['params'][name],
            'batch_stats': variables['batch_stats'][name]}


def test_second_and_second_fpn(radar):
    variables, model = radar
    rng = np.random.RandomState(2)
    canvas = np.maximum(rng.randn(2, *PC.bev_hw, 64), 0).astype(np.float32)
    feats = jax.jit(lambda v, x: JaxSECOND(
        PC.second_layer_nums, PC.second_strides,
        PC.second_channels).apply(v, x, train=False))(
            _sub(variables, 'SECOND_0'), canvas)
    bev = jax.jit(lambda v, f: JaxSECONDFPN(
        PC.fpn_strides, PC.fpn_channels).apply(v, f, train=False))(
            _sub(variables, 'SECONDFPN_0'), feats)
    with torch.no_grad():
        got = model.second(torch.from_numpy(canvas).permute(0, 3, 1, 2))
        got_bev = model.second_fpn(got)
    for g, w in zip(got, feats):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-5)
    assert got_bev.shape == (2, sum(PC.fpn_channels), *PC.head_hw)
    np.testing.assert_allclose(got_bev.permute(0, 2, 3, 1).numpy(),
                               np.asarray(bev), rtol=1e-4, atol=1e-5)


def test_dense_pillar_indices_match_jitted_jax_off_powers_of_two():
    """0.3 m pillars, points on the bin edges: jitted JAX bins
    ``(x - x0) * f32(1 / 0.3)`` (XLA's form of ``/ 0.3``), which floors 8
    of the 48 x edges and 3 of the 32 y edges into the next pillar; the
    port's canvas holds the same pillars (occupancy equal) and values."""
    vs, pcr, hw = (0.3, 0.3, 8.0), (-7.2, -4.8, -3.0, 7.2, 4.8, 5.0), (32, 48)
    rng = np.random.RandomState(7)
    pts = rng.uniform(-1, 1, (2, 400, 8)).astype(np.float32)
    pts[..., 0] = (pcr[0] + rng.randint(0, 48, (2, 400)) * 0.3).astype(
        np.float32)
    pts[..., 1] = (pcr[1] + rng.randint(0, 32, (2, 400)) * 0.3).astype(
        np.float32)
    pts[..., 2] = rng.uniform(-2, 4, (2, 400))
    mask = np.ones((2, 400), bool)
    jax_mod = JaxDensePillarEncoder(feat_channels=(64,), voxel_size=vs,
                                    point_cloud_range=pcr, grid_hw=hw)
    v = random_variables(jax_mod, pts, mask, False)
    want = np.asarray(jax.jit(lambda v, p, m: jax_mod.apply(v, p, m, False))(
        v, pts, mask))
    p, s = v['params']['PFNLayer_0'], v['batch_stats']['PFNLayer_0']
    port = DensePillarEncoder(8, (64,), vs, pcr, hw)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in {
        'pfn.0.linear.weight': p['Dense_0']['kernel'].T,
        'pfn.0.bn.weight': p['BatchNorm_0']['scale'],
        'pfn.0.bn.bias': p['BatchNorm_0']['bias'],
        'pfn.0.bn.running_mean': s['BatchNorm_0']['mean'],
        'pfn.0.bn.running_var': s['BatchNorm_0']['var']}.items()},
        strict=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pts), torch.from_numpy(mask))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got.any(-1), want.any(-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
