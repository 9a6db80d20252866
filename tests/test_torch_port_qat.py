"""Quantization-aware training (``QConv2d`` in ``'qat'`` mode, port
``models/quant.py``) against the JAX package's ``quant.Conv._qat`` on the
CPU, and the QAT flow of the port.

* the conv's outputs and its ``act_amax`` sequence (an EMA, the first
  batch setting it) over 3 batches of different scales, within 1e-6 of
  max|ref| in f32, at two shapes (3x3 with a bias; 1x1 stride 2 without);
* the straight-through gradients of the kernel, the bias and the input
  against ``jax.grad``, within 1e-5 of max|ref|;
* the space-to-depth stem (``S2DStem``) records the same EMA as JAX's
  ``_S2DStem`` and stays float;
* under ``models/layers.py:remat`` the recomputation does not update the
  EMA again: one update a step, gradients bit-equal to the run without
  remat;
* a ``make_train_step`` step of a small BEVFusion under the bf16 policy
  in ``qat`` leaves every ``QConv2d`` a finite ``act_amax > 0``;
  ``freeze`` then gives a quant state that ``Predictor`` serves in int8.

JAX's quant mode is process-wide: the fixture resets it to ``'off'``,
and each JAX callable is jitted fresh (XLA turns ``/ 127.0`` into a
product with ``float32(1/127)``, as the port's scales compute it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from omnihd_scenes_tpu.models import quant as jquant
from omnihd_scenes_tpu.models.resnet import _S2DStem as JaxS2DStem
from omnihd_scenes_tpu_torch.models.layers import remat
from omnihd_scenes_tpu_torch.models.quant import (MODES, QConv2d,
                                                  quant_state, set_mode)
from omnihd_scenes_tpu_torch.models.resnet import S2DStem, space_to_depth_np

torch.set_num_threads(1)

SCALES = (1.0, 3.0, 0.5)


@pytest.fixture(autouse=True)
def _reset_mode():
    yield
    jquant.set_mode('off')


# (flax Conv kwargs, torch QConv2d kwargs)
CASES = {
    '3x3_bias': (dict(kernel_size=(3, 3), padding=[(1, 1), (1, 1)]),
                 dict(kernel_size=3, padding=1)),
    '1x1_s2': (dict(kernel_size=(1, 1), strides=(2, 2), padding='VALID',
                    use_bias=False),
               dict(kernel_size=1, stride=2, bias=False)),
}
C_IN, C_OUT = 16, 24


def _case(name, seed=0):
    """(flax module, variables, port module with the same weights,
    batches NHWC)."""
    fkw, tkw = CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 10, 12, C_IN).astype(np.float32)
    m = jquant.Conv(C_OUT, **fkw)
    params = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0),
                                             x)['params'])
    params = {k: rng.normal(0, 0.2, v.shape).astype(np.float32)
              for k, v in params.items()}
    conv = QConv2d(C_IN, C_OUT, **tkw)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            params['kernel'].transpose(3, 2, 0, 1).copy()))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(params['bias']))
    batches = [(x * s).astype(np.float32) for s in SCALES]
    return m, params, conv, batches


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize('name', list(CASES))
def test_qat_conv_and_ema_match_jax(name):
    m, params, conv, batches = _case(name)
    jquant.set_mode('qat')
    apply = jax.jit(lambda v, x: m.apply(v, x, mutable=['quant']))
    set_mode(conv, 'qat')
    variables = {'params': params}
    for x in batches:
        want, muts = apply(variables, x)
        variables = {'params': params, 'quant': muts['quant']}
        got = conv(_nchw(x))
        _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-6)
        _close(float(conv.act_amax), muts['quant']['act_amax'], 1e-6)
    # The three scales moved the EMA away from the first batch's amax.
    first = float(np.abs(batches[0]).max())
    assert abs(float(conv.act_amax) - first) > 1e-3 * first


@pytest.mark.parametrize('name', list(CASES))
def test_qat_straight_through_gradients_match_jax(name):
    m, params, conv, batches = _case(name, seed=1)
    x = batches[1]
    y_shape = jax.eval_shape(lambda: m.apply({'params': params}, x)).shape
    g = np.random.RandomState(2).randn(*y_shape).astype(np.float32)
    jquant.set_mode('qat')

    def loss(p, xin):
        out, _ = m.apply({'params': p}, xin, mutable=['quant'])
        return jnp.sum(out * g)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    set_mode(conv, 'qat')
    xt = _nchw(x).requires_grad_(True)
    (conv(xt) * _nchw(g)).sum().backward()
    _close(conv.weight.grad.numpy(),
           np.asarray(gp['kernel']).transpose(3, 2, 0, 1), 1e-5)
    _close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, 1e-5)
    if conv.bias is not None:
        _close(conv.bias.grad.numpy(), gp['bias'], 1e-5)


def test_s2d_stem_records_the_jax_ema():
    rng = np.random.RandomState(3)
    img = rng.randn(1, 16, 24, 3).astype(np.float32)
    packed = space_to_depth_np(img)
    m = JaxS2DStem(8)
    kernel = rng.normal(0, 0.1, (7, 7, 3, 8)).astype(np.float32)
    stem = S2DStem(3, 8)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)
                                           .copy()))
    jquant.set_mode('qat')
    apply = jax.jit(lambda v, x: m.apply(v, x, mutable=['quant']))
    set_mode(stem, 'qat')
    variables = {'params': {'kernel': kernel}}
    for s in SCALES:
        x = (packed * s).astype(np.float32)
        want, muts = apply(variables, x)
        variables = {**variables, 'quant': muts['quant']}
        got = stem(_nchw(x))
        _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5)
        _close(float(stem.act_amax), muts['quant']['act_amax'], 1e-6)
    # The stem stays float: freeze stores no int8 weights.
    set_mode(stem, 'freeze')
    stem(_nchw(packed))
    assert set(quant_state(stem)) == {'.act_amax'}


def _trunk(seed):
    torch.manual_seed(seed)
    return nn.Sequential(QConv2d(8, 8, 3, padding=1), nn.ReLU(),
                         QConv2d(8, 8, 3, padding=1, bias=False))


def test_remat_updates_the_ema_once_a_step():
    plain, checked = _trunk(0), _trunk(0)
    calls = []
    for m in checked:
        if isinstance(m, QConv2d):
            m.register_forward_pre_hook(lambda mod, args: calls.append(mod))
    set_mode(plain, 'qat')
    set_mode(checked, 'qat')
    rng = np.random.RandomState(4)
    for step, s in enumerate(SCALES):
        x = torch.from_numpy(rng.randn(2, 8, 6, 6).astype(np.float32) * s)
        plain(x).square().sum().backward()
        remat(checked, x.clone().requires_grad_(True)).square().sum() \
            .backward()
        # The forward and the backward's recomputation, each conv.
        assert len(calls) == 4 * (step + 1)
        for a, b in zip(plain, checked):
            if isinstance(a, QConv2d):
                assert torch.equal(a.act_amax, b.act_amax)
                assert torch.equal(a.weight.grad, b.weight.grad)
                a.weight.grad = b.weight.grad = None


def test_modes_name_qat():
    assert 'qat' in MODES
    with pytest.raises(ValueError, match="'qat'"):
        set_mode(_trunk(0), 'qta')


def test_qat_steps_then_int8_serving():
    """The flow of the chip's QAT phase at a small size (the remat test's
    small BEVFusion): make_train_step under the bf16 policy in 'qat', then
    freeze and the int8 network of ``Predictor(quant_state=...)``."""
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict,
                                                         random_train_batch)
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import AdamW
    from omnihd_scenes_tpu_torch.weights import load_state_dict
    from tests.test_torch_port_remat import small_config

    cfg = small_config()
    model = BEVFusion(cfg)
    load_state_dict(model, random_state_dict(cfg, 1))
    state = create_train_state(model, lambda p: AdamW(p, lambda step: 1e-4))
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        model, 'bevfusion', cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range)))
    set_mode(model, 'qat')
    # Points uniform over +-50 m: 4096 put some in the small range (+-16
    # m), so the pillar stream's convs see a nonzero input.
    state, loss, _ = step(state, random_train_batch(
        np.random.RandomState(5), cfg, 1, n_points=4096))
    assert torch.isfinite(loss)
    qconvs = [n for n, m in model.named_modules() if isinstance(m, QConv2d)]
    amax = {k[:-len('.act_amax')]: v for k, v in quant_state(model).items()}
    assert set(amax) == set(qconvs)
    assert all(bool(torch.isfinite(v)) and float(v) > 0
               for v in amax.values())

    set_mode(model, 'freeze')
    request = random_request(np.random.RandomState(6), cfg, 1,
                             n_points=4096)
    with torch.no_grad():
        model.eval()(*(None if x is None else torch.from_numpy(x)
                       for x in request))
    qstate = quant_state(model)
    assert {k.rpartition('.')[2] for k in qstate} == {'act_amax', 'w8',
                                                      'w_scale'}
    int8 = Predictor(cfg, model.state_dict(), device='cpu',
                     dtype=torch.float32, quant_state=qstate)
    assert all(int8.model.get_submodule(n).mode == 'int8' for n in qconvs)
    out = int8.forward(*request)
    assert all(bool(torch.isfinite(out[k]).all())
               for k in ('cls_score', 'bbox_pred', 'dir_pred'))
