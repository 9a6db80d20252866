"""``QConv2d`` (``omnihd_scenes_tpu_torch/models/quant.py``) against the
JAX package's ``quant.Conv``, mode by mode, and the ``quant`` collection
bridge of ``weights.py``, on the CPU.

Codes, ``act_amax``, ``w8`` and ``w_scale`` must be bit-equal to JAX's
as JAX runs them, under ``jax.jit`` (see ``ops/qconv.py`` of the port).
int8 outputs: both sides sum the same int8 codes exactly (JAX in int32,
the port in f64 for eligible layers and in f32 below 2^24 for the
others, which these shapes stay under) and apply the same f32
epilogue, so they agree within one f32 rounding.

JAX's quant mode is process-wide: every test that sets it resets it to
``'off'`` (fixture below), and every jitted callable is made fresh per
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from omnihd_scenes_tpu.models import quant as jquant
from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu.ops.qconv import quantize_weights as jax_quantize_w
from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.quant import (
    QConv2d, load_quant_state, qconv_eligible, quant_state, set_mode)
from omnihd_scenes_tpu_torch.serve.predictor import calibrate
from omnihd_scenes_tpu_torch.weights import (flax_quant_to_torch,
                                             flax_to_torch,
                                             torch_quant_to_flax)
from tests.test_torch_port_qconv import nchw, nhwc_np
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           flat_paths, mini_inputs,
                                           mini_variables, random_variables)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_mode():
    yield
    jquant.set_mode('off')


# (flax Conv kwargs, torch QConv2d kwargs, in channels, out channels)
CASES = {
    '3x3_s1_eligible': (dict(kernel_size=(3, 3), padding=[(1, 1), (1, 1)]),
                        dict(kernel_size=3, padding=1), 128, 128),
    '3x3_s2': (dict(kernel_size=(3, 3), strides=(2, 2),
                    padding=[(1, 1), (1, 1)], use_bias=False),
               dict(kernel_size=3, stride=2, padding=1, bias=False), 32, 48),
    '3x3_d6': (dict(kernel_size=(3, 3), kernel_dilation=(6, 6),
                    padding=[(6, 6), (6, 6)], use_bias=False),
               dict(kernel_size=3, dilation=6, padding=6, bias=False), 32, 48),
    '1x1': (dict(kernel_size=(1, 1)), dict(kernel_size=1), 32, 48),
}


def _pair(case, dtype=torch.float32, seed=1):
    """A JAX quant.Conv and a port QConv2d on the same random weights,
    and an NHWC input."""
    fkw, tkw, c, co = CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 24, 28, c).astype(np.float32)
    jmod = jquant.Conv(co, **fkw)
    v = random_variables(jmod, x, seed=seed)
    tmod = QConv2d(c, co, **tkw)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(
            v['params']['kernel'].transpose(3, 2, 0, 1).copy()))
        if tmod.bias is not None:
            tmod.bias.copy_(torch.from_numpy(v['params']['bias']))
    tmod = tmod.to(dtype=dtype, memory_format=torch.channels_last)
    if dtype == torch.bfloat16:
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return jmod, v, tmod, x


def _jax_apply(jmod, v, x, mode, mutable=False):
    jquant.set_mode(mode)
    fn = jax.jit(lambda v, x: jmod.apply(
        v, x, mutable=['quant'] if mutable else False))
    return fn(v, jnp.asarray(x))


@torch.inference_mode()
def _port(tmod, x, dtype):
    return tmod(nchw(np.asarray(x, np.float32)).to(dtype))


@pytest.mark.parametrize('case', sorted(CASES))
def test_off_mode_is_nn_conv(case):
    _, _, tmod, x = _pair(case)
    ref = nn.Conv2d(tmod.in_channels, tmod.out_channels, tmod.kernel_size,
                    tmod.stride, tmod.padding, tmod.dilation,
                    bias=tmod.bias is not None)
    ref.load_state_dict(tmod.state_dict())
    xt = nchw(x)
    assert tmod.mode == 'off'
    assert torch.equal(tmod(xt), ref(xt))
    for mode in ('off', 'calib', 'freeze', 'int8'):
        set_mode(tmod, mode)
        tmod(xt)
        assert list(tmod.state_dict()) == list(ref.state_dict()), mode


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_calib_and_freeze_bit_equal(dtype):
    jmod, v, tmod, x = _pair('3x3_s1_eligible', dtype)
    x2 = x * 3
    _, muts = _jax_apply(jmod, v, x, 'calib', mutable=True)
    _, muts = _jax_apply(jmod, {**v, 'quant': muts['quant']}, x2, 'calib',
                         mutable=True)
    _, muts = _jax_apply(jmod, {**v, 'quant': muts['quant']}, x, 'freeze',
                         mutable=True)
    want = {k: np.asarray(a) for k, a in muts['quant'].items()}

    set_mode(tmod, 'calib')
    _port(tmod, x, dtype)
    _port(tmod, x2, dtype)
    set_mode(tmod, 'freeze')
    y = _port(tmod, x, dtype)
    set_mode(tmod, 'off')
    assert torch.equal(y, _port(tmod, x, dtype))      # freeze runs float
    assert tmod.act_amax.dtype == tmod.w_scale.dtype == torch.float32
    assert tmod.act_amax.numpy().tobytes() == want['act_amax'].tobytes()
    assert tmod.w_scale.numpy().tobytes() == want['w_scale'].tobytes()
    assert tmod.w8.dtype == torch.int8
    assert tmod.w8.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(tmod.w8.numpy().transpose(2, 3, 1, 0),
                                  want['w8'])


@pytest.mark.parametrize('frozen', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_int8_matches_jax(case, frozen):
    """Same act_amax (JAX's) on both sides; frozen or in-graph weights."""
    jmod, v, tmod, x = _pair(case)
    _, muts = _jax_apply(jmod, v, x, 'calib', mutable=True)
    if frozen:
        _, muts = _jax_apply(jmod, {**v, 'quant': muts['quant']}, x,
                             'freeze', mutable=True)
    want = np.asarray(_jax_apply(jmod, {**v, 'quant': muts['quant']}, x,
                                 'int8'))
    launches = qconv3x3.launches
    state = {k: torch.from_numpy(np.asarray(a)) for k, a in
             muts['quant'].items()}
    if frozen:
        state['w8'] = state['w8'].permute(3, 2, 0, 1)
    _load_single(tmod, state)
    set_mode(tmod, 'int8')
    got = nhwc_np(_port(tmod, x, torch.float32))
    assert qconv3x3.launches == launches
    y_float = np.asarray(_jax_apply(jmod, v, x, 'off'))
    assert np.abs(want - y_float).max() > 1e-4 * np.abs(y_float).max()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22,
                               atol=2.0 ** -22 * np.abs(want).max())


def _load_single(tmod, state):
    """load_quant_state on a model holding just ``tmod``."""
    holder = nn.Module()
    holder.m = tmod
    load_quant_state(holder, {f'm.{k}': t for k, t in state.items()})


def test_uncalibrated_layer_runs_float():
    _, _, tmod, x = _pair('3x3_s1_eligible')
    y = _port(tmod, x, torch.float32)
    for mode in ('freeze', 'int8'):
        set_mode(tmod, mode)
        assert torch.equal(_port(tmod, x, torch.float32), y), mode
        assert tmod.w8 is None


def test_eligibility_gate():
    """``tests/test_quant.py:test_fused_eligibility_gate`` without the
    backend and VMEM terms."""
    assert qconv_eligible(QConv2d(128, 128, 3, padding=1))
    assert qconv_eligible(QConv2d(128, 128, 3, padding='same'))
    assert not qconv_eligible(QConv2d(128, 128, 3, stride=2, padding=1))
    assert not qconv_eligible(QConv2d(128, 128, 3, dilation=2, padding=2))
    assert not qconv_eligible(QConv2d(128, 96, 3, padding=1))
    assert not qconv_eligible(QConv2d(128, 128, 1))
    assert not qconv_eligible(QConv2d(64, 128, 3, padding=1))
    assert not qconv_eligible(QConv2d(128, 128, 3, padding=0))
    assert not qconv_eligible(QConv2d(128, 128, 3, padding=1, groups=2))
    assert not qconv_eligible(QConv2d(128, 128, 3, padding=1,
                                      padding_mode='reflect'))


def test_cast_keeps_quant_state_dtypes():
    _, _, tmod, x = _pair('3x3_s1_eligible')
    set_mode(tmod, 'calib')
    _port(tmod, x, torch.float32)
    set_mode(tmod, 'freeze')
    _port(tmod, x, torch.float32)
    before = {k: getattr(tmod, k).clone() for k in ('act_amax', 'w_scale',
                                                    'w8')}
    tmod.to(torch.bfloat16)
    assert tmod.weight.dtype == torch.bfloat16
    for k, t in before.items():
        assert torch.equal(getattr(tmod, k), t) and \
            getattr(tmod, k).dtype == t.dtype, k
    assert tmod.w8.is_contiguous(memory_format=torch.channels_last)


@pytest.fixture(scope='module')
def jax_quant_shapes():
    """Leaf paths and shapes of the JAX mini BEVFusion's ``quant``
    collection after calib and after freeze (traced, not run)."""
    model, inputs = JaxBEVFusion(JAX_MINI_CFG), mini_inputs()
    variables = mini_variables()
    out = {}
    try:
        for mode in ('calib', 'freeze'):
            jquant.set_mode(mode)
            if mode == 'freeze':
                variables = {**variables, 'quant': out['calib']}
            muts = jax.eval_shape(lambda v: model.apply(
                v, *inputs, train=False, mutable=['quant'])[1], variables)
            out[mode] = jax.tree.map(
                lambda s: np.zeros(s.shape, s.dtype), muts['quant'])
    finally:
        jquant.set_mode('off')
    return out


def test_bridge_covers_the_jax_quant_leaves(jax_quant_shapes):
    """The port's QConv2d sites are exactly the JAX QConv sites: 94 convs
    of the mini config, 282 leaves after freeze."""
    state = calibrate(PORT_MINI_CFG,
                      flax_to_torch(mini_variables(), PORT_MINI_CFG),
                      [mini_inputs()], device='cpu', dtype=torch.float32)
    want = flat_paths(jax_quant_shapes['freeze'])
    assert len(want) == 282 and len(flat_paths(jax_quant_shapes['calib'])) \
        == 94
    got = flat_paths(torch_quant_to_flax(state, PORT_MINI_CFG))
    assert set(got) == set(want)
    for path, v in want.items():
        assert got[path].shape == v.shape and got[path].dtype == v.dtype, path
    # Frozen weights equal the (jitted) JAX quantizer on the JAX kernels.
    params = flat_paths(mini_variables()['params'])
    quantize = jax.jit(jax_quantize_w)
    for path, v in got.items():
        if path[-1] == 'w8':
            w8, sw = quantize(jnp.asarray(params[path[:-1] + ('kernel',)]))
            np.testing.assert_array_equal(v, np.asarray(w8), str(path))
            np.testing.assert_array_equal(got[path[:-1] + ('w_scale',)],
                                          np.asarray(sw), str(path))


def test_bridge_round_trip_bit_equal(jax_quant_shapes):
    rng = np.random.RandomState(0)
    quant = jax.tree.map(
        lambda z: (rng.randint(-127, 128, z.shape).astype(np.int8)
                   if z.dtype == np.int8 else
                   np.asarray(rng.rand(*z.shape), np.float32)),
        jax_quant_shapes['freeze'])
    state = flax_quant_to_torch(quant, PORT_MINI_CFG)
    assert len(state) == 282
    back = flat_paths(torch_quant_to_flax(state, PORT_MINI_CFG))
    want = flat_paths(quant)
    assert set(back) == set(want)
    for path, v in want.items():
        assert back[path].dtype == v.dtype, path
        np.testing.assert_array_equal(back[path], v, str(path))
    model = BEVFusion(PORT_MINI_CFG)
    load_quant_state(model, state)
    assert quant_state(model).keys() == state.keys()
    with pytest.raises(KeyError, match='no QConv2d'):
        load_quant_state(model, {'head.conv_cls.act_amax': torch.ones(())})
    with pytest.raises(KeyError, match='no conv'):
        flax_quant_to_torch({'Nope_0': {'act_amax': np.ones(())}},
                            PORT_MINI_CFG)
