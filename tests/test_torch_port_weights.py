"""Weight bridge between the JAX package and the PyTorch port.

Also home of the helpers the other ``test_torch_port_*`` files share:
the mini BEVFusion configuration of ``tests/test_full_graph_parity.py``
in its serving modes (``splat_mode='sample'``, ``pillar_impl='dense'``),
in both packages, and random flax variables made from a seed with NumPy.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn

from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu_torch import config as port_config
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, init_weights,
                                             load_state_dict, name_map,
                                             torch_to_flax)
from tests.test_full_graph_parity import FUSION_CFG, _inputs, _randomize

torch.set_num_threads(1)

JAX_MINI_CFG = dataclasses.replace(
    FUSION_CFG,
    lss=dataclasses.replace(FUSION_CFG.lss, splat_mode='sample'),
    pillars=dataclasses.replace(FUSION_CFG.pillars, pillar_impl='dense'))

_PORT_CLASSES = {'lss': port_config.LSSConfig,
                 'pillars': port_config.PointPillarsConfig}


def to_port_config(cfg, cls=port_config.BEVFusionConfig):
    """A JAX config dataclass -> the port's, field by field."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = to_port_config(v, _PORT_CLASSES[f.name])
        kw[f.name] = v
    return cls(**kw)


PORT_MINI_CFG = to_port_config(JAX_MINI_CFG)


def mini_inputs():
    """(points, mask, imgs, rots, trans) of the mini config, seeded."""
    return _inputs()


def random_variables(module, *args, seed=3, **kwargs):
    """Random params AND batch stats for a flax module (shapes by
    ``eval_shape``, values by NumPy from ``seed``)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return jax.tree.map(np.asarray, _randomize(shapes, seed))


@functools.lru_cache(maxsize=1)
def mini_variables():
    """Random variables of the mini BEVFusion (cached per process; treat
    as read-only)."""
    return random_variables(JaxBEVFusion(JAX_MINI_CFG), *mini_inputs(),
                            train=False)


def flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope='module')
def variables():
    return mini_variables()


def test_round_trip_bit_equal(variables):
    """flax -> torch -> flax returns every param and batch stat of the
    mini BEVFusion bit for bit, and nothing else."""
    back = flat_paths(torch_to_flax(flax_to_torch(variables, PORT_MINI_CFG),
                                    PORT_MINI_CFG))
    want = flat_paths(variables)
    assert set(back) == set(want)
    for path, v in want.items():
        assert back[path].dtype == np.float32, path
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))


def test_state_dict_covers_the_model(variables):
    """The bridge fills every parameter and buffer of the port's model
    (BatchNorm step counters aside) with the right shape."""
    model = BEVFusion(PORT_MINI_CFG)
    sd = flax_to_torch(variables, PORT_MINI_CFG)
    load_state_dict(model, sd)
    own = model.state_dict()
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
        torch.testing.assert_close(own[k], v, rtol=0, atol=0)
    assert len(set(name_map(PORT_MINI_CFG).values())) == len(sd)


def test_load_rejects_a_missing_key(variables):
    sd = flax_to_torch(variables, PORT_MINI_CFG)
    sd.pop('fuse.conv.weight')
    with pytest.raises(KeyError, match='fuse.conv.weight'):
        load_state_dict(BEVFusion(PORT_MINI_CFG), sd)


@pytest.mark.parametrize('stride', [1, 2, 4])
def test_conv_transpose_layout(stride):
    """flax ConvTranspose (no kernel transpose) == torch conv_transpose2d
    on the bridged (spatially flipped) kernel."""
    from omnihd_scenes_tpu_torch.weights import _flax_to_torch_layout

    rng = np.random.RandomState(stride)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    mod = fnn.ConvTranspose(6, (stride, stride), strides=(stride, stride),
                            use_bias=False)
    v = random_variables(mod, x)
    want = np.asarray(mod.apply(v, x))
    k = _flax_to_torch_layout(v['params']['kernel'],
                              ('params', 'ConvTranspose_0', 'kernel'))
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(k.copy()), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_init_weights_is_seeded():
    def weights(seed):
        model = BEVFusion(PORT_MINI_CFG)
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, c = weights(0), weights(0), weights(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a['fuse.conv.weight'], c['fuse.conv.weight'])
    w = a['resnet.layer1.0.conv2.weight']             # LeCun normal
    assert abs(float(w.std()) - w[0].numel() ** -0.5) < 0.1 * w[0].numel() ** -0.5
