"""Conv+BN fusion of the port (``serve/fuse.py``) against the JAX
package's ``serve/fuse.py`` on the CPU, and the serving of a fused
checkpoint.

* On the mini BEVFusion with ResNet18 (``JAX_CFG`` / ``PORT_CFG``, the
  mini configuration cut as ``tests/test_torch_port_profile.py`` cuts
  it) with seeded LeCun-normal weights (flax's
  initialiser, ``serve/synthetic.py:random_state_dict``) bridged to flax,
  BN statistics drawn away from (0, 1) by
  ``tests/test_fuse_conv_bn.py:_randomize_bn`` (``mini_variables``' N(0,
  0.05) kernels under such statistics grow the head maps to ~5e5, where
  ``verify``'s elementwise 1e-3 fails on f32 rounding): the port's pairs,
  mapped through ``weights.name_map``, equal JAX's (``trace_pairs`` of JAX
  runs on an abstract evaluation of the forward, ``jax.eval_shape``: the
  interceptor sees the same module calls and tracer identities), so do the
  fused and skipped lists, and ``flax_to_torch`` of JAX's fused variables
  equals the port's fused state dict bit for bit: both compute
  ``scale / sqrt(var + eps)``, the products and ``b - s_f * m`` as single
  f32 operations in the same order.
* JAX's guard cases: a conv feeding two BNs is skipped and left as it is;
  a residual consumer makes ``verify`` raise.  A ``ConvTranspose2d`` pair
  (scaled along dim 1) and a ``Linear`` pair (the PFN's 2-D view) fold.
* The fused forward within 1e-5 of max|ref| of the unfused one in f32;
  ``Predictor`` folds the passthroughs into their producers: one folded
  block equals its passthrough within 1e-6 of max|ref| in f32, the whole
  network within ``NETWORK_FOLD_TOL`` (2e-6; each conv adds the folded
  bias in its own rounding).
* bf16: a passthrough cast to bf16 scales its input by K_bf16 /
  sqrt(K^2_bf16 + eps) = 0.99771 (computed and pinned here); the folded
  model carries no such gain: its bf16 forward stays within the bf16
  tolerance of the unfused bf16 forward, and its head maps' centred
  gain within ``GAIN_TOL`` of 1, where the fused checkpoint cast to bf16
  with its passthroughs left in falls outside it.  ``StreamPredictor``
  folds a fused mini BEVFormer's passthroughs likewise, and
  ``serving_model`` refuses to serve in bf16 a passthrough it cannot fold.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch import nn

from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu.serve.fuse import fuse_conv_bn as jax_fuse_conv_bn
from omnihd_scenes_tpu.serve.fuse import trace_pairs as jax_trace_pairs
from omnihd_scenes_tpu_torch.config import BEVFormerConfig
from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.layers import (BN_EPS, BatchNorm,
                                                   ConvBNReLU, DeconvBNReLU)
from omnihd_scenes_tpu_torch.models.pillar_encoders import PFNLayer
from omnihd_scenes_tpu_torch.serve.fuse import (K, fold_passthroughs,
                                                fuse_conv_bn, fuse_model,
                                                passthrough_bns, trace_pairs)
from omnihd_scenes_tpu_torch.serve.predictor import (Predictor,
                                                     StreamPredictor,
                                                     serving_model)
from omnihd_scenes_tpu_torch.serve.synthetic import (
    random_bevformer_state_dict, random_state_dict, random_stream_frame)
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, load_state_dict,
                                             name_map, torch_to_flax)
from tests.test_fuse_conv_bn import _randomize_bn
from tests.test_torch_port_weights import (JAX_MINI_CFG, mini_inputs,
                                           to_port_config)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_CFG = dataclasses.replace(JAX_MINI_CFG, resnet_depth=18)
PORT_CFG = to_port_config(JAX_CFG)

# The whole mini network, folded against passthrough, f32: the fold moves
# each bias into its conv, which adds it to the accumulator one rounding
# apart from a separate add (1 ulp a layer, ~60 layers in series; the
# network reads 1.08e-6 of max|ref|, one block alone stays within 1e-6).
NETWORK_FOLD_TOL = 2e-6
# bf16's 8 bits of mantissa: the folded bf16 forward against the unfused
# bf16 one (each rounds every layer's output once more or less); reads
# 1.05e-2 of max|ref| on cls_score, 0.99e-2 on bbox_pred.
BF16_TOL = 2e-2
# The least-squares gain of a bf16 head map against the unfused one,
# each channel centred (:func:`_centred_gain`), on cls_score / bbox_pred:
# bf16 rounding is no gain (the folded model reads 1.0002 / 1.0008), the
# passthroughs left in bf16 are one (0.9882 / 0.9875, ~5.5 passthroughs
# of 0.99771 in series); ``pytest -s`` prints them.
GAIN_TOL = 3e-3


def _flax_path(key):
    """A torch module name -> its flax module path, through the name map
    of one of its parameters."""
    nm = name_map(PORT_CFG)
    return '/'.join(nm[f'{key}.weight'][1:-1])


@pytest.fixture(scope='module')
def mini():
    variables = _randomize_bn(torch_to_flax(
        random_state_dict(PORT_CFG, 0), PORT_CFG))
    jax_model = JaxBEVFusion(JAX_CFG)
    inputs = mini_inputs()
    # JAX's fuse_model(verify=False) in its two steps, keeping the pairs.
    jax_pairs, jax_eps = jax_trace_pairs(
        lambda v: jax.eval_shape(lambda: jax_model.apply(v, *inputs,
                                                         train=False)),
        variables)
    jax_fused, jax_report = jax_fuse_conv_bn(variables, jax_pairs, jax_eps)
    model = BEVFusion(PORT_CFG)
    sd = flax_to_torch(variables, PORT_CFG)
    load_state_dict(model, sd)
    t_inputs = [torch.from_numpy(x) for x in inputs]

    def run():
        return model(*t_inputs)

    pairs, eps = trace_pairs(run, model)
    fused, report = fuse_conv_bn(sd, pairs, eps, model)
    return dict(model=model, sd=sd, run=run, pairs=pairs, fused=fused,
                report=report, inputs=inputs, jax_fused=jax_fused,
                jax_report=jax_report, jax_pairs=jax_pairs)


def test_pairs_and_reports_equal_jax(mini):
    got = {_flax_path(bn): _flax_path(lin)
           for bn, lin in mini['pairs'].items()}
    want = {'/'.join(bn): '/'.join(lin)
            for bn, lin in mini['jax_pairs'].items()}
    assert got == want
    # Every BatchNorm of the model follows its producer directly.
    assert len(got) == sum(isinstance(m, BatchNorm)
                           for m in mini['model'].modules())
    assert sorted(map(_flax_path, mini['report']['fused'])) == sorted(
        mini['jax_report']['fused'])
    assert mini['report']['skipped'] == mini['jax_report']['skipped'] == []


def test_fused_weights_equal_jax_bit_for_bit(mini):
    want = flax_to_torch(mini['jax_fused'], PORT_CFG)
    got = mini['fused']
    assert set(want) <= set(got)
    changed = 0
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        changed += not torch.equal(mini['sd'][k], w)
    # Every fused pair changed its producer's weight and its BN's four
    # leaves (the heads' and the other unpaired weights stay).
    assert changed >= 5 * len(mini['pairs'])


def test_fused_forward_matches_unfused_f32(mini):
    model, run = mini['model'], mini['run']
    with torch.no_grad():
        want = model.eval()(*[torch.from_numpy(x) for x in mini['inputs']])
        load_state_dict(model, mini['fused'])
        try:
            got = run()
        finally:
            load_state_dict(model, mini['sd'])
    for k in ('cls_score', 'bbox_pred', 'dir_pred'):
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-5 * float(want[k].abs().max()), (k, err)


def _forward(predictor, inputs):
    return predictor.forward(*inputs)


def _centred_gain(got, want):
    """g minimising |got - g * want| over a (..., C) map, each channel
    centred first (the heads' per-channel biases carry no gain)."""
    c = want.shape[-1]
    a = got.float().reshape(-1, c)
    r = want.float().reshape(-1, c)
    a, r = a - a.mean(0), r - r.mean(0)
    return float((a * r).sum() / (r * r).sum())


def test_predictor_folds_the_passthroughs_f32(mini):
    model = BEVFusion(PORT_CFG)
    load_state_dict(model, mini['fused'])
    assert len(passthrough_bns(model)) == len(mini['pairs'])
    # The passthrough forward in the Predictor's channels_last layout (the
    # convs' summation order depends on it).
    model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        want = model(*[torch.from_numpy(x) for x in mini['inputs']])
    pred = Predictor(PORT_CFG, mini['fused'], device='cpu',
                     dtype=torch.float32)
    assert not any(isinstance(m, BatchNorm) and n in mini['pairs']
                   for n, m in pred.model.named_modules())
    assert sum(isinstance(m, nn.Identity)
               for m in pred.model.modules()) == len(mini['pairs'])
    got = _forward(pred, mini['inputs'])
    for k in ('cls_score', 'bbox_pred', 'dir_pred'):
        err = float((got[k] - want[k]).abs().max())
        assert err <= NETWORK_FOLD_TOL * float(want[k].abs().max()), (k, err)


def test_one_folded_passthrough_is_the_passthrough_f32():
    """One fused block alone: the passthrough (x * 1.0 + b) against the
    folded conv (b in the conv's bias), within 1e-6 of max|ref|."""
    torch.manual_seed(1)
    block = ConvBNReLU(16, 16, 3).eval()
    with torch.no_grad():
        block.bn.weight.fill_(K)
        block.bn.running_var.fill_(K * K)
        block.bn.bias.normal_()
    x = torch.randn(2, 16, 12, 12)
    with torch.no_grad():
        want = block(x)
    assert fold_passthroughs(block, ['bn'], lambda: block(x)) == ['bn']
    assert isinstance(block.bn, nn.Identity)
    with torch.no_grad():
        got = block(x)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_bf16_passthrough_gain_is_not_served(mini):
    k16 = torch.tensor(K, dtype=torch.bfloat16)
    kk16 = torch.tensor(K * K, dtype=torch.bfloat16)
    gain = float(k16.float() / torch.sqrt(kk16.float() + 1e-5))
    assert (float(k16), float(kk16)) == (9984.0, 100139008.0)
    assert abs(gain - 0.99771) < 5e-6, gain
    # One passthrough cast to bf16 as it stands carries that gain.
    block = ConvBNReLU(8, 8, 3)
    block.bn.eval()
    with torch.no_grad():
        block.bn.weight.fill_(K)
        block.bn.running_var.fill_(K * K)
        block.bn.bias.zero_()
        x = torch.rand(1, 8, 6, 6).to(torch.bfloat16)
        y32 = block.conv.to(torch.bfloat16)(x).float()
        y16 = block.bn.to(torch.bfloat16)(y32.to(torch.bfloat16)).float()
    ratio = float((y16 * y32).sum() / (y32 * y32).sum())
    assert abs(ratio - gain) < 2e-3, ratio
    # The Predictor folds them: its bf16 forward stays within the bf16
    # tolerance of the unfused model's and carries no gain.  The control:
    # the fused checkpoint cast to bf16 as it stands, its passthroughs
    # left in, carries one.
    want_pred = Predictor(PORT_CFG, mini['sd'], device='cpu',
                          dtype=torch.bfloat16)
    want = _forward(want_pred, mini['inputs'])
    got = _forward(Predictor(PORT_CFG, mini['fused'], device='cpu',
                             dtype=torch.bfloat16), mini['inputs'])
    unfolded = BEVFusion(PORT_CFG)
    load_state_dict(unfolded, mini['fused'])
    want_pred.model = unfolded.to(dtype=torch.bfloat16,
                                  memory_format=torch.channels_last).eval()
    bad = _forward(want_pred, mini['inputs'])
    for k in ('cls_score', 'bbox_pred'):
        err = float((got[k].float() - want[k].float()).abs().max())
        assert err <= BF16_TOL * float(want[k].float().abs().max()), (k, err)
        g, g_unfolded = (_centred_gain(got[k], want[k]),
                         _centred_gain(bad[k], want[k]))
        print(f'{k}: centred gain folded {g:.5f}, unfolded {g_unfolded:.5f}')
        assert abs(g - 1) <= GAIN_TOL < 1 - g_unfolded, (k, g, g_unfolded)


def _rand_bn(bn, seed):
    g = torch.Generator().manual_seed(seed)
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(torch.rand(n, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(n, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(n, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(n, generator=g) + 0.5)


class _TwoBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn0, self.bn1 = BatchNorm(8, BN_EPS), BatchNorm(8, BN_EPS)

    def forward(self, x):
        y = self.conv(x)
        return self.bn0(y) + self.bn1(y)


class _Residual(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 3, 3, padding=1)
        self.bn = BatchNorm(3, BN_EPS)

    def forward(self, x):
        y = self.conv(x)
        return self.bn(y) + y


def _toy(kind):
    """(module, input) of a guard or fold case."""
    torch.manual_seed(0)
    if kind == 'deconv':
        return DeconvBNReLU(6, 8, 2), torch.randn(2, 6, 5, 5)
    if kind == 'linear':
        return PFNLayer(9, 8), torch.randn(2, 7, 4, 9)
    return {'two_bns': _TwoBN, 'residual': _Residual}[kind](), \
        torch.randn(1, 3, 8, 8)


@pytest.mark.parametrize('kind', ['two_bns', 'residual', 'deconv', 'linear'])
def test_guard_and_fold_cases(kind):
    module, x = _toy(kind)
    for i, bn in enumerate(m for m in module.modules()
                           if isinstance(m, BatchNorm)):
        _rand_bn(bn, i)
    module.eval()
    if kind == 'residual':
        with pytest.raises(ValueError, match='verification failed'):
            fuse_model(module, lambda: module(x))
        return
    with torch.no_grad():
        want = module(x)
    fused, report = fuse_model(module, lambda: module(x))
    if kind == 'two_bns':
        assert report['fused'] == []
        assert report['skipped'] == ['bn0 (producer feeds multiple BNs)',
                                     'bn1 (producer feeds multiple BNs)']
        assert torch.equal(fused['conv.weight'],
                           module.state_dict()['conv.weight'])
        return
    assert report['fused'] == ['bn'] and not report['skipped']
    w = 'deconv.weight' if kind == 'deconv' else 'linear.weight'
    s_f = module.bn.weight / torch.sqrt(module.bn.running_var
                                        + module.bn.eps)
    axis = 1 if kind == 'deconv' else 0
    shape = [1] * fused[w].dim()
    shape[axis] = -1
    assert torch.equal(fused[w], module.state_dict()[w] * s_f.view(shape))
    load_state_dict(module, fused)
    with torch.no_grad():
        got = module(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_stream_predictor_folds_a_fused_bevformer_bf16():
    """The synthetic BEVFormer cut to 2 cameras of 64x96, BN statistics
    drawn away from (0, 1): fused as ``tools/fuse_conv_bn.py`` fuses it
    (``forward_stream`` on a zero previous BEV), then served in bf16 by
    ``StreamPredictor`` with every passthrough folded, within the bf16
    tolerance of the unfused checkpoint's frame."""
    kw = Config.fromfile(
        str(ROOT / 'configs/synthetic/bevformer_synth.py')).model.to_dict()
    cfg = dataclasses.replace(BEVFormerConfig(**kw), num_cams=2,
                              img_hw=(64, 96))
    model = BEVFormerDetector(cfg)
    load_state_dict(model, random_bevformer_state_dict(cfg, 0))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for i, bn in enumerate(bns):
        _rand_bn(bn, i)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    frame = [torch.from_numpy(x) for x in StreamPredictor._zero_frame(cfg)]
    fused, report = fuse_model(model, lambda: model.forward_stream(*frame))
    assert len(report['fused']) == len(bns) and not report['skipped']

    request = (*random_stream_frame(np.random.RandomState(1), cfg, 2),
               np.zeros((2, cfg.bev_h * cfg.bev_w, cfg.embed_dims),
                        np.float32), np.array([False, False]))
    pred = StreamPredictor(cfg, fused, device='cpu', dtype=torch.bfloat16)
    assert not any(isinstance(m, BatchNorm) for m in pred.model.modules())
    (_, got, _, _), got_bev = pred(*request)
    (_, want, _, _), want_bev = StreamPredictor(
        cfg, sd, device='cpu', dtype=torch.bfloat16)(*request)
    # The decoded scores, sorted: the k-th largest moves no further than
    # the largest elementwise change of the scores it is drawn from.
    for g, w in ((got, want), (got_bev, want_bev)):
        err = float((g.float() - w.float()).abs().max())
        assert err <= BF16_TOL * float(w.float().abs().max()), err


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_serving_model_refuses_an_unfoldable_passthrough_in_bf16(dtype):
    """A conv feeding two passthrough BNs has no single BN to fold: f32
    serves them as they stand (exact), bf16 refuses."""
    module, x = _toy('two_bns')
    with torch.no_grad():
        for bn in (module.bn0, module.bn1):
            bn.weight.fill_(K)
            bn.running_var.fill_(K * K)
    assert passthrough_bns(module) == ['bn0', 'bn1']
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match='no producer of their own'):
            serving_model(module, 'cpu', dtype, lambda: (x,))
        return
    served = serving_model(module, 'cpu', dtype, lambda: (x,))
    assert isinstance(served.bn0, BatchNorm)
    assert isinstance(served.bn1, BatchNorm)
