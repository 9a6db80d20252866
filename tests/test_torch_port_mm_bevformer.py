"""The port's ``MMBEVFormerLayer`` (``models/bevformer/encoder.py``)
against the JAX package's at the mini shapes of
``tests/test_misc_components.py:TestMMLayer`` (48 queries of 32 channels,
4 heads, 2 cameras, FFN 64, a 16-channel LiDAR BEV), with flax's weights
carried over by the bridge (``weights.py:MMBEVFormerLayerSpec``) and the
fusion gates moved off their zero initialisation: the output of two
samples within 1e-4 of max|ref| of each sample's JAX result; the
variables back through the bridge unchanged.  One JAX evaluation per
sample, shared by the tests through a module-scoped fixture."""

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.bevformer.encoder import (
    MMBEVFormerLayer as JaxMMBEVFormerLayer, get_reference_points_2d)
from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
    BEVFormerLayer, MMBEVFormerLayer)
from omnihd_scenes_tpu_torch.weights import (MMBEVFormerLayerSpec,
                                             flax_to_torch, load_state_dict,
                                             torch_to_flax)

NQ, C, HEADS, CAMS, FFN, LIDAR = 48, 32, 4, 2, 64, 16
BEV_SHAPES, CAM_SHAPES = ((6, 8),), ((4, 6),)


def _sample(rng):
    bev_q = rng.randn(NQ, C).astype(np.float32)
    ref2d = np.asarray(get_reference_points_2d(6, 8))
    return dict(
        bev_query=bev_q, bev_pos=rng.randn(NQ, C).astype(np.float32),
        value_queue=np.stack([rng.randn(NQ, C).astype(np.float32), bev_q]),
        ref_2d_queue=np.stack([ref2d + 0.05, ref2d]).astype(np.float32),
        cam_values=rng.randn(CAMS, 24, C).astype(np.float32),
        reference_points_cam=rng.uniform(0.2, 0.8, (CAMS, NQ, 4, 2)).astype(
            np.float32),
        bev_mask=rng.uniform(size=(CAMS, NQ, 4)) < 0.7,
        lidar_bev=rng.randn(NQ, LIDAR).astype(np.float32))


def _jax_args(s):
    return (s['bev_query'], s['bev_pos'], s['value_queue'],
            s['ref_2d_queue'], s['cam_values'], s['reference_points_cam'],
            s['bev_mask'], BEV_SHAPES, CAM_SHAPES, s['lidar_bev'])


@pytest.fixture(scope='module')
def jax_case():
    """Two samples, the flax layer's variables (gates at 0.7 and -0.4) and
    its output on each sample."""
    rng = np.random.RandomState(0)
    samples = [_sample(rng) for _ in range(2)]
    layer = JaxMMBEVFormerLayer(embed_dims=C, num_heads=HEADS, num_cams=CAMS,
                                feedforward_channels=FFN)
    variables = jax.tree.map(np.array, layer.init(
        jax.random.PRNGKey(0), *_jax_args(samples[0])))
    variables['params']['fusion_w_cam'][:] = 0.7
    variables['params']['fusion_w_pts'][:] = -0.4
    outs = [np.asarray(layer.apply(variables, *_jax_args(s)))
            for s in samples]
    return samples, variables, outs


def _port_layer(variables):
    layer = MMBEVFormerLayer(LIDAR, embed_dims=C, num_heads=HEADS,
                             feedforward_channels=FFN, num_cams=CAMS)
    load_state_dict(layer, flax_to_torch(variables, MMBEVFormerLayerSpec()))
    return layer.eval()


def test_forward_matches_jax(jax_case):
    samples, variables, outs = jax_case
    layer = _port_layer(variables)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in samples[0]}
    with torch.no_grad():
        got = layer(batch['bev_query'], batch['bev_pos'],
                    batch['value_queue'], batch['ref_2d_queue'],
                    batch['cam_values'], batch['reference_points_cam'],
                    batch['bev_mask'], BEV_SHAPES, CAM_SHAPES,
                    batch['lidar_bev'])
    assert got.shape == (2, NQ, C)
    for i, want in enumerate(outs):
        err = np.abs(got[i].numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, (i, err)


def test_gates_move_the_output(jax_case):
    """The LiDAR branch reaches the output: with its gate shut (a large
    negative logit) the layer's output changes."""
    samples, variables, _ = jax_case
    layer = _port_layer(variables)
    s = {k: torch.from_numpy(v)[None] for k, v in samples[0].items()}
    args = (s['bev_query'], s['bev_pos'][0], s['value_queue'],
            s['ref_2d_queue'], s['cam_values'], s['reference_points_cam'],
            s['bev_mask'], BEV_SHAPES, CAM_SHAPES, s['lidar_bev'])
    with torch.no_grad():
        open_ = layer(*args)
        layer.fusion_w_pts.fill_(-30.0)
        shut = layer(*args)
    assert (open_ - shut).abs().max() > 1e-2


def test_bridge_round_trip(jax_case):
    _, variables, _ = jax_case
    layer = _port_layer(variables)
    back = torch_to_flax(layer.state_dict(), MMBEVFormerLayerSpec())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    for path, v in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, v)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    # Every torch parameter is mapped: the bridge's keys are the layer's.
    assert set(layer.state_dict()) == set(
        flax_to_torch(variables, MMBEVFormerLayerSpec()))


def test_adds_gates_and_lidar_proj_to_the_camera_layer():
    layer = MMBEVFormerLayer(LIDAR, embed_dims=C, num_heads=HEADS,
                             feedforward_channels=FFN, num_cams=CAMS)
    cam_only = BEVFormerLayer(embed_dims=C, num_heads=HEADS,
                              feedforward_channels=FFN, num_cams=CAMS)
    extra = set(layer.state_dict()) - set(cam_only.state_dict())
    assert extra == {'fusion_w_cam', 'fusion_w_pts', 'lidar_proj.weight',
                     'lidar_proj.bias'}
    assert layer.fusion_w_cam.item() == layer.fusion_w_pts.item() == 0.0
