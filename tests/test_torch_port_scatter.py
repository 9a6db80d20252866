"""The scatter view transform (``splat_mode='scatter'``, the reference's
``bev_pool_v2`` splat-sum) of the port against the JAX package on the
CPU:

* ``LSSConfig.frustum`` equal to JAX's, at production and mini sizes;
* ``frustum_voxel_ids`` at production size (6 ring-rig cameras x 59 bins
  x 136x240 = 11.55 M points a sample, grid 16x160x240): an id may differ
  from JAX's only where the point's f64 coordinate lies within
  ``FACE_TOL`` voxels of a voxel face (a summation order moving it across);
* ``bev_pool_v2`` and ``lss_splat`` on JAX's ids (the mini config's rig),
  f32: equal to JAX's scatter (both add in index order on the CPU);
  ``lss_splat`` invariant to its chunk size in f64 within 1e-12 of
  max|ref|, and its gradient equal to ``jax.grad`` within 1e-6;
* ``LiftSplatShoot`` in scatter mode (CamEncode, 6 cameras of the mini
  rig, 8x8x4 grid, eval-mode BatchNorm) with JAX's weights: BEV and depth
  within 1e-4 of max|ref|, and the gradient of a seeded projection of the
  BEV for every parameter and the camera features within 1e-4 of each
  leaf's max|ref| (f32, different conv summation orders);
* a scatter ``Predictor`` at the mini BEVFusion configuration: finite
  boxes, one splat per sample, and a BEV that differs from the sampling
  dual's (the two are different functions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.lss import LSSConfig as JaxLSSConfig
from omnihd_scenes_tpu.models.lss import LiftSplatShoot as JaxLSS
from omnihd_scenes_tpu.ops import bev_pool as jax_bev_pool
from omnihd_scenes_tpu_torch.config import BEVFusionConfig, LSSConfig
from omnihd_scenes_tpu_torch.models.lss import LiftSplatShoot
from omnihd_scenes_tpu_torch.ops.bev_pool import (bev_pool_v2,
                                                  frustum_voxel_ids,
                                                  lss_splat)
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_img2lidar
from omnihd_scenes_tpu_torch.weights import (_flax_to_torch_layout,
                                             flax_to_torch, name_map)
from tests.test_full_graph_parity import LSS_CFG as JAX_MINI_LSS
from tests.test_torch_port_weights import (PORT_MINI_CFG, mini_inputs,
                                           mini_variables, random_variables,
                                           to_port_config)

torch.set_num_threads(1)

FACE_TOL = 1e-6
TOL = 1e-4
PORT_MINI_LSS = to_port_config(JAX_MINI_LSS, LSSConfig)
# CamEncode in place of DepthNet keeps the module's f32 gradient cheap.
JAX_SMALL_LSS = dataclasses.replace(JAX_MINI_LSS, inputC=32, camC=8,
                                    outC=16)
PORT_SMALL_LSS = to_port_config(JAX_SMALL_LSS, LSSConfig)


def _geometry(cfg):
    return (tuple(cfg.pc_range[:3]), (cfg.grid,) * 3, cfg.bev_nx)


def _jax_ids(cfg, rots, trans):
    fn = jax.jit(jax_bev_pool.frustum_voxel_ids, static_argnums=(3, 4, 5))
    return np.array(fn(jnp.asarray(cfg.frustum()), rots, trans,
                         *_geometry(cfg)))


def _port_ids(cfg, rots, trans):
    return frustum_voxel_ids(torch.from_numpy(cfg.frustum()),
                             torch.as_tensor(rots), torch.as_tensor(trans),
                             *_geometry(cfg)).numpy()


@pytest.mark.parametrize('which', ['production', 'mini'])
def test_frustum_matches_jax(which):
    jcfg = JaxLSSConfig() if which == 'production' else JAX_MINI_LSS
    pcfg = LSSConfig() if which == 'production' else PORT_MINI_LSS
    got, want = pcfg.frustum(), jcfg.frustum()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (pcfg.depth_bins, *pcfg.feat_hw, 3)


def test_voxel_ids_at_production_size():
    cfg = LSSConfig()
    rots, trans = ring_rig_img2lidar(img_hw=cfg.final_dim)
    got, want = _port_ids(cfg, rots, trans), _jax_ids(cfg, rots, trans)
    assert got.shape == (6, 59, 136, 240) and got.dtype == np.int32
    n_cells = int(np.prod(cfg.bev_nx))
    assert 0.3 < float((want < n_cells).mean()) < 0.7
    bad = np.nonzero(got != want)
    if bad[0].size:
        f = cfg.frustum().astype(np.float64)
        uvd = np.concatenate([f[..., :2] * f[..., 2:3], f[..., 2:3]], -1)
        pts = np.einsum('nij,dhwj->ndhwi', rots.astype(np.float64), uvd)
        pts = pts + trans.astype(np.float64)[:, None, None, None]
        c = (pts[bad] - np.asarray(cfg.pc_range[:3])) / cfg.grid
        assert float(np.abs(c - np.round(c)).min(-1).max()) < FACE_TOL
    assert bad[0].size < 10, bad[0].size


def test_voxel_ids_drop_nan_and_far_points():
    cfg = PORT_MINI_LSS
    _, _, _, rots, trans = mini_inputs()
    rots, trans = rots[0].copy(), trans[0].copy()
    rots[1] = np.nan
    trans[2] += 1e9
    ids = _port_ids(cfg, rots, trans)
    n_cells = int(np.prod(cfg.bev_nx))
    assert (ids[1:3] == n_cells).all()
    np.testing.assert_array_equal(ids[0], _jax_ids(cfg, rots, trans)[0])


def test_bev_pool_v2_matches_jax():
    rng = np.random.RandomState(0)
    depth = rng.rand(1, 2, 3, 4, 5).astype(np.float32)
    feat = rng.randn(1, 2, 4, 5, 8).astype(np.float32)
    shape = (1, 2, 3, 4, 8)
    n_cells, p = 24, 400
    rd = rng.randint(0, depth.size, p).astype(np.int32)
    rf = rng.randint(0, feat.size // 8, p).astype(np.int32)
    rb = rng.randint(0, n_cells + 4, p).astype(np.int32)   # some dropped
    valid = rng.rand(p) < 0.8
    want = np.asarray(jax.jit(jax_bev_pool.bev_pool_v2, static_argnums=5)(
        depth, feat, rd, rf, rb, shape, valid=valid))
    t = torch.from_numpy
    got = bev_pool_v2(t(depth), t(feat), t(rd), t(rf), t(rb), shape,
                      valid=t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == shape and np.abs(got).max() > 0


@pytest.fixture(scope='module')
def splat_case():
    """The mini config's depth, features and JAX's ids of its rig."""
    cfg = PORT_MINI_LSS
    _, _, _, rots, trans = mini_inputs()
    rng = np.random.RandomState(1)
    n, (h, w), d = 6, cfg.feat_hw, cfg.depth_bins
    logits = rng.randn(n, d, h, w).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    feat = rng.randn(n, h, w, cfg.camC).astype(np.float32)
    ids = _jax_ids(JAX_MINI_LSS, rots[0], trans[0])
    return depth, feat, ids, int(np.prod(cfg.bev_nx))


def test_voxel_ids_match_jax_on_the_mini_rig(splat_case):
    _, _, _, rots, trans = mini_inputs()
    ids, n_cells = splat_case[2], splat_case[3]
    np.testing.assert_array_equal(_port_ids(PORT_MINI_LSS, rots[0],
                                            trans[0]), ids)
    assert 0 < int((ids < n_cells).sum()) < ids.size


def test_lss_splat_matches_jax(splat_case):
    depth, feat, ids, n_cells = splat_case
    want = np.asarray(jax.jit(jax_bev_pool.lss_splat, static_argnums=3)(
        depth, feat, ids, n_cells))
    t = torch.from_numpy
    calls = lss_splat.calls
    got = lss_splat(t(depth), t(feat), t(ids), n_cells).numpy()
    assert lss_splat.calls == calls + 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('chunk_d', [1, 3, 8])
def test_lss_splat_chunk_invariance(splat_case, chunk_d):
    depth, feat, ids, n_cells = splat_case
    t = lambda a: torch.from_numpy(a).double()   # noqa: E731
    ref = lss_splat(t(depth), t(feat), torch.from_numpy(ids), n_cells)
    got = lss_splat(t(depth), t(feat), torch.from_numpy(ids), n_cells,
                    chunk_d=chunk_d)
    assert ref.dtype == torch.float64
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_lss_splat_gradient_matches_jax(splat_case):
    depth, feat, ids, n_cells = splat_case
    proj = np.random.RandomState(2).randn(n_cells, feat.shape[-1]).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda d, f: jnp.sum(
        jax_bev_pool.lss_splat(d, f, ids, n_cells) * proj), (0, 1)))(
            depth, feat)
    d, f = (torch.from_numpy(a).requires_grad_() for a in (depth, feat))
    (lss_splat(d, f, torch.from_numpy(ids), n_cells)
     * torch.from_numpy(proj)).sum().backward()
    for got, ref in zip((d.grad, f.grad), want):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-6, err


def _lss_state_dict(variables, port_cfg: LSSConfig):
    """A bare LiftSplatShoot's state_dict from a bare JAX module's
    variables: the bridge's ``lss.*`` keys with the module scope dropped."""
    cfg = BEVFusionConfig(lss=port_cfg, use_depthnet=False,
                          radar_stream=False, lc_fusion=False, se=False,
                          with_head=False)
    sd = {}
    for key, path in name_map(cfg).items():
        if key.startswith('lss.'):
            v = variables[path[0]]
            for k in path[2:]:
                v = v[k]
            v = _flax_to_torch_layout(np.asarray(v, np.float32), path)
            sd[key[4:]] = torch.from_numpy(v.copy())
    return sd


@pytest.fixture(scope='module')
def lss_outputs():
    _, _, _, rots, trans = mini_inputs()
    cfg = JAX_SMALL_LSS
    rng = np.random.RandomState(3)
    feats = rng.randn(1, 6, *PORT_SMALL_LSS.feat_hw, cfg.inputC).astype(
        np.float32)
    jmodel = JaxLSS(cfg, use_depthnet=False)
    variables = random_variables(jmodel, feats, rots, trans, train=False)
    proj = rng.randn(1, *reversed(PORT_SMALL_LSS.bev_nx[:2]),
                     cfg.outC).astype(np.float32)

    def loss(params, x):
        bev, _, _ = jmodel.apply({**variables, 'params': params}, x, rots,
                                 trans, train=False)
        return jnp.sum(bev * proj)

    bev, depth, _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, rots, trans, train=False))(variables, feats)
    g_params, g_x = jax.jit(jax.grad(loss, (0, 1)))(variables['params'],
                                                     feats)
    model = LiftSplatShoot(PORT_SMALL_LSS, cfg.inputC,
                           use_depthnet=False).eval()
    model.load_state_dict(_lss_state_dict(variables, PORT_SMALL_LSS))
    x = torch.from_numpy(feats[0]).permute(0, 3, 1, 2).requires_grad_()
    calls = lss_splat.calls
    out, p_depth, _ = model(x, torch.from_numpy(rots),
                            torch.from_numpy(trans))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(proj)).sum().backward()
    return dict(bev=(out.permute(0, 2, 3, 1).detach().numpy(),
                     np.asarray(bev)),
                depth=(p_depth.detach().numpy(), np.asarray(depth)),
                g_x=(x.grad.permute(0, 2, 3, 1).numpy()[None],
                     np.asarray(g_x)),
                g_params=(model, g_params, variables), calls=lss_splat.calls
                - calls)


@pytest.mark.parametrize('key', ['bev', 'depth', 'g_x'])
def test_lss_module_matches_jax(lss_outputs, key):
    got, want = lss_outputs[key]
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
    assert lss_outputs['calls'] == 1


def test_lss_module_parameter_gradients_match_jax(lss_outputs):
    model, g_params, variables = lss_outputs['g_params']
    grads = {f'lss.{k}': p.grad for k, p in model.named_parameters()}
    cfg = BEVFusionConfig(lss=PORT_SMALL_LSS, use_depthnet=False,
                          radar_stream=False, lc_fusion=False, se=False,
                          with_head=False)
    n = 0
    for key, path in name_map(cfg).items():
        if path[0] != 'params' or not key.startswith('lss.'):
            continue
        want = g_params
        for k in path[2:]:
            want = want[k]
        want = _flax_to_torch_layout(np.asarray(want), path)
        got = grads[key].numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < TOL, (key, err)
        n += 1
    assert n == len(grads)


def test_scatter_predictor_serves_the_mini_config():
    sd = flax_to_torch(mini_variables(), PORT_MINI_CFG)
    scatter = dataclasses.replace(
        PORT_MINI_CFG, lss=dataclasses.replace(PORT_MINI_CFG.lss,
                                               splat_mode='scatter'))
    inputs = mini_inputs()
    calls = lss_splat.calls
    predictor = Predictor(scatter, sd, device='cpu', dtype=torch.float32)
    boxes, scores, labels, valid = predictor(*inputs)
    assert lss_splat.calls == calls + 1
    assert boxes.shape == (1, 500, 9) and bool(torch.isfinite(boxes).all())
    got = predictor.forward(*inputs)['bev']
    dual = Predictor(PORT_MINI_CFG, sd, device='cpu',
                     dtype=torch.float32).forward(*inputs)['bev']
    assert got.shape == dual.shape and not torch.allclose(got, dual)
