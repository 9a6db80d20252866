"""The int8 PTQ tier of BEVFusion-OCC (``MTLConfig``; root ``bench.py
--mtl --int8``) in the port against the JAX package on the CPU, at the
narrow BEVFusion-OCC configuration of ``tests/test_torch_port_mtl.py``
(ResNet18, 64/96-channel BEVs, 16x16 BEV at 1 m, occupancy 16x16x4 over
12 classes), one sample with two of its six cameras (JAX's integer convs
run slowly on the CPU), shared weights as drawn (BatchNorm biases of +4
saturate the depth softmax, and the int8 network's code flips then move
whole maps):

* trunk mode 'none' (the shipped model): the port's ``calibrate`` records
  JAX's calibration key for key through the int8 bridge, every
  ``act_amax`` within 1e-5 relative (activations that differ by f32
  summation order), and freezes every calibrated conv with ``w8`` /
  ``w_scale`` equal to JAX's ``quantize_weights`` of its kernel (what
  JAX's freeze stores); the occupancy head's convs, plain convs in JAX,
  get no quant state;
* ``Predictor(..., quant_state=JAX's calibration)`` against JAX's int8
  forward (both quantize the weights in the graph, which is bit-equal to
  freezing them, ``tests/test_quant.py``): head
  maps, the BEV, depth and the occupancy logits within ``TOL`` of
  max|ref| and closer to JAX's int8 maps than the float network is (as
  ``tests/test_torch_port_int8.py`` holds BEVFusion); the occupancy argmax
  equal wherever JAX's two best logits differ by more than 1e-3 of
  max|logit|, and returned after the boxes;
* trunk modes 'per_task' and 'shared': the quant collection's paths of
  JAX's calibration (traced, not run) equal the port's state mapped
  through the bridge, key for key, task trunks included.
"""

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models import quant as jquant
from omnihd_scenes_tpu.models.mtl import BEVFusionMTL as JaxBEVFusionMTL
from omnihd_scenes_tpu.ops.qconv import quantize_weights as jax_quantize
from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
from omnihd_scenes_tpu_torch.weights import (flax_quant_to_torch,
                                             flax_to_torch, name_map,
                                             torch_quant_to_flax)
from tests.test_torch_port_mtl import INPUT_KEYS, configs, mtl_batch
from tests.test_torch_port_weights import flat_paths, random_variables

torch.set_num_threads(1)

TOL = 1e-3
KEYS = ('cls_score', 'bbox_pred', 'dir_pred', 'bev', 'depth', 'occ_logits')


def one_sample(cameras=6):
    """The first sample of ``mtl_batch()``'s inputs, with its first
    ``cameras`` cameras."""
    batch = mtl_batch()
    inputs = [batch[k][:1] for k in INPUT_KEYS]
    return inputs[:2] + [a[:, :cameras] for a in inputs[2:]]


def _jax_apply(model, variables, inputs, mode):
    try:
        jquant.set_mode(mode)
        if mode == 'calib':
            fn = jax.jit(lambda v, *a: model.apply(
                v, *a, train=False, mutable=['quant'])[1]['quant'])
            return jax.tree.map(np.asarray, fn(variables, *inputs))
        out = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
            variables, *inputs)
        return {k: np.asarray(v) for k, v in out.items() if v is not None}
    finally:
        jquant.set_mode('off')


@pytest.fixture(scope='module')
def none_case():
    jcfg, pcfg = configs('none')
    inputs = one_sample(cameras=2)
    jmodel = JaxBEVFusionMTL(jcfg)
    variables = random_variables(jmodel, *inputs, train=False)
    quant = _jax_apply(jmodel, variables, inputs, 'calib')
    out = _jax_apply(jmodel, dict(variables, quant=quant), inputs, 'int8')

    sd = flax_to_torch(variables, pcfg)
    state = calibrate(pcfg, sd, [inputs], device='cpu', dtype=torch.float32)
    int8 = Predictor(pcfg, sd, device='cpu', dtype=torch.float32,
                     quant_state=flax_quant_to_torch(quant, pcfg))
    port_out = {k: v.numpy() for k, v in int8.forward(*inputs).items()
                if v is not None}
    final = [t.numpy() for t in int8(*inputs)]
    float_out = Predictor(pcfg, sd, device='cpu',
                          dtype=torch.float32).forward(*inputs)
    return dict(pcfg=pcfg, variables=variables, quant=quant, out=out,
                state=state,
                port_out=port_out, final=final,
                float_out={k: float_out[k].numpy() for k in KEYS})


def test_calibration_matches_jax(none_case):
    got, pcfg = none_case['state'], none_case['pcfg']
    want = flax_quant_to_torch(none_case['quant'], pcfg)
    amax = [k for k in got if k.endswith('.act_amax')]
    assert set(amax) == set(want) and len(amax) > 40
    assert len(got) == 3 * len(amax)
    assert not [k for k in got if k.startswith('occ_head.')]
    assert any(k.startswith('fusion.lss.') for k in amax)
    kernels = name_map(pcfg)
    quantize = jax.jit(jax_quantize)
    for k in amax:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        path = kernels[k[:-len('act_amax')] + 'weight']
        v = none_case['variables']
        for p in path:
            v = v[p]
        w8, sw = (np.asarray(a) for a in quantize(v))
        name = k[:-len('.act_amax')]
        np.testing.assert_array_equal(got[f'{name}.w8'].numpy(),
                                      w8.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[f'{name}.w_scale'].numpy(), sw)


@pytest.mark.parametrize('key', KEYS)
def test_int8_maps_match_jax(none_case, key):
    got, want = none_case['port_out'][key], none_case['out'][key]
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
    float_gap = np.abs(none_case['float_out'][key] - want).max()
    assert np.abs(got - want).max() < 0.5 * float_gap


def test_occupancy_argmax_after_the_boxes(none_case):
    boxes, scores, labels, valid, occ = none_case['final']
    assert boxes.shape == (1, 500, 9) and valid.sum() > 0
    logits = none_case['out']['occ_logits']
    assert occ.shape == logits.shape[:-1] and occ.dtype == np.int64
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * np.abs(logits).max()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(occ[clear], logits.argmax(-1)[clear])


@pytest.mark.parametrize('mode', ['per_task', 'shared'])
def test_trunk_mode_quant_keys_match_jax(mode):
    jcfg, pcfg = configs(mode)
    inputs = one_sample(cameras=1)
    jmodel = JaxBEVFusionMTL(jcfg)
    variables = random_variables(jmodel, *inputs, train=False)
    try:
        jquant.set_mode('calib')
        shapes = jax.eval_shape(lambda v, *a: jmodel.apply(
            v, *a, train=False, mutable=['quant'])[1]['quant'],
            variables, *inputs)
    finally:
        jquant.set_mode('off')
    sd = flax_to_torch(variables, pcfg)
    state = calibrate(pcfg, sd, [inputs], device='cpu', dtype=torch.float32)
    amax = {k: v for k, v in state.items() if k.endswith('.act_amax')}
    assert set(flat_paths(torch_quant_to_flax(amax, pcfg))) == set(
        flat_paths(shapes))
    trunks = ('det_trunk', 'occ_trunk') if mode == 'per_task' else (
        'shared_trunk',)
    for trunk in trunks:
        assert f'{trunk}.stem.conv.w8' in state
