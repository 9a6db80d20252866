"""Sorted pillars of the port against the JAX package, f32: ``voxelize``
bit-equal to jitted JAX (features, counts, coords, validity), with points
out of range, masked padding, pillars over ``max_points`` and more
pillars than ``max_voxels``; ``PillarFeatureNet`` + ``scatter_to_bev``
(one and two PFN layers, the RadarPillarNet offsets) within 1e-5 of
max|ref| in eval and train mode, where the PFN BatchNorm's batch
statistics run over every (B, V, P) slot, padding included; the new
running statistics within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.pillar_encoders import (
    PillarFeatureNet as JaxPillarFeatureNet)
from omnihd_scenes_tpu.ops.voxelize import scatter_to_bev as jax_scatter
from omnihd_scenes_tpu.ops.voxelize import voxelize as jax_voxelize
from omnihd_scenes_tpu_torch.models.pillar_encoders import PillarFeatureNet
from omnihd_scenes_tpu_torch.ops.voxelize import scatter_to_bev, voxelize
from tests.test_torch_port_radar import _points
from tests.test_torch_port_weights import JAX_MINI_CFG, random_variables

torch.set_num_threads(1)

PC = JAX_MINI_CFG.pillars
TOL = 1e-5


def _jax_voxelize(pts, mask, max_voxels, max_points, pcr=PC.point_cloud_range,
                  voxel=PC.voxel_size):
    fn = jax.jit(jax.vmap(lambda p, m: jax_voxelize(p, m, pcr, voxel,
                                                    max_voxels, max_points)))
    return jax.tree.map(np.asarray, fn(pts, mask))


@pytest.mark.parametrize('max_voxels,max_points', [(512, 16), (40, 3),
                                                   (512, 1)],
                         ids=['roomy', 'both-caps-overflow', 'one-point'])
def test_voxelize_bit_equal(max_voxels, max_points):
    pts, mask = _points()
    want = _jax_voxelize(pts, mask, max_voxels, max_points)
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                   PC.point_cloud_range, PC.voxel_size, max_voxels,
                   max_points)
    for name in ('features', 'num_points', 'coords', 'valid'):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if max_voxels == 40:       # both capacities really overflow
        assert want.valid.all() and want.num_points.max() == 3


def test_voxelize_other_voxel_size():
    """A voxel size whose reciprocal is not exact in f32 (0.3 m): the
    port's ``* (1 / vx)`` is what jitted JAX computes."""
    pts, mask = _points(seed=3)
    want = _jax_voxelize(pts, mask, 2048, 8, voxel=(0.3, 0.3, 8.0))
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                   PC.point_cloud_range, (0.3, 0.3, 8.0), 2048, 8)
    np.testing.assert_array_equal(got.coords.numpy(), want.coords)
    np.testing.assert_array_equal(got.features.numpy(), want.features)


def _state_dict(v, n_layers):
    sd = {}
    for i in range(n_layers):
        p, s = v['params'][f'PFNLayer_{i}'], v['batch_stats'][f'PFNLayer_{i}']
        sd.update({
            f'pfn.{i}.linear.weight': p['Dense_0']['kernel'].T,
            f'pfn.{i}.bn.weight': p['BatchNorm_0']['scale'],
            f'pfn.{i}.bn.bias': p['BatchNorm_0']['bias'],
            f'pfn.{i}.bn.running_mean': s['BatchNorm_0']['mean'],
            f'pfn.{i}.bn.running_var': s['BatchNorm_0']['var']})
    return {k: torch.from_numpy(np.ascontiguousarray(x))
            for k, x in sd.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('channels,velocity', [((64,), False),
                                               ((32, 64), False),
                                               ((64,), True)],
                         ids=['pfn64', 'pfn32-64', 'radar-pillarnet'])
def test_pillar_feature_net_and_scatter(channels, velocity, train):
    pts, mask = _points(seed=2)
    vox = _jax_voxelize(pts, mask, 128, 8)
    jax_mod = JaxPillarFeatureNet(
        feat_channels=channels, voxel_size=PC.voxel_size,
        point_cloud_range=PC.point_cloud_range,
        with_velocity_snr_center=velocity)
    args = (vox.features, vox.num_points, vox.coords)
    v = random_variables(jax_mod, *args, False)

    def run(v, *a):
        pf, mut = jax_mod.apply(v, *a, train, mutable=['batch_stats'])
        pf = jax.numpy.where(vox.valid[..., None], pf, 0.0)
        canvas = jax.vmap(lambda f, c, m: jax_scatter(f, c, m, PC.bev_hw))(
            pf, vox.coords, vox.valid)
        return canvas, mut['batch_stats']

    want, stats = jax.jit(run)(v, *args)

    port = PillarFeatureNet(8, channels, PC.voxel_size, PC.point_cloud_range,
                            velocity)
    port.load_state_dict(_state_dict(v, len(channels)), strict=False)
    port.train(train)
    t = [torch.from_numpy(np.array(a)) for a in (vox.features, vox.num_points,
                                       vox.coords, vox.valid)]
    with torch.no_grad():
        pf = port(*t[:3])
        got = scatter_to_bev(pf, t[2], t[3], PC.bev_hw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    for i in range(len(channels)):
        bn = port.pfn[i].bn
        s = stats[f'PFNLayer_{i}']['BatchNorm_0']
        _close(bn.running_mean.numpy(), s['mean'])
        _close(bn.running_var.numpy(), s['var'])
