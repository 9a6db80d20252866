"""The int8 PTQ serving slice: the port's ``Predictor(..., quant_state=)``
on the CPU (f32) against JAX ``BEVFusion`` in int8 mode, at the mini
configuration of ``tests/test_torch_port_weights.py`` (production channel
widths, so the fused-kernel layers are eligible), with shared weights and
the same JAX-calibrated ``act_amax``.

JAX runs calib and int8 once (module fixture; an int8 apply takes tens of
seconds on the CPU).  It skips ``freeze``, which is bit-equal to the
in-graph quantization both sides then do (``tests/test_quant.py``); the
frozen-weight path is held to JAX module by module in
``tests/test_torch_port_quant.py``.

Tolerance: TOL of the reference's largest magnitude (gain-normalised), as
for the float slice.  Both sides quantize activations that differ only by
f32 summation order, so a code differs only where an activation sits
within an f32 rounding of a .5 boundary; but each such flip moves a conv
output by a whole code step, which moves later activations across more
boundaries.  Measured on a CPU: 1.5e-5 (depth) to 4.5e-4 (bev) of
max|ref|, about a tenth of the distance between the int8 and the float
network (7e-4 to 5.6e-3), so each map must also lie within half that
distance of JAX's int8 output: the port follows the quantized graph, not
the float one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models import quant as jquant
from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg, anchor_head_decode_candidates)
from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
from omnihd_scenes_tpu_torch.models.anchor_head import decode_at
from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
from omnihd_scenes_tpu_torch.weights import flax_quant_to_torch, flax_to_torch
from tests.test_torch_port_bevfusion import assert_close_gain
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           mini_inputs, mini_variables)

torch.set_num_threads(1)

TOL = 1e-3
KEYS = ('bev', 'cls_score', 'bbox_pred', 'dir_pred', 'depth',
        'depth_logits')


@pytest.fixture(scope='module')
def int8_outputs():
    inputs = mini_inputs()
    variables = mini_variables()
    model = JaxBEVFusion(JAX_MINI_CFG)
    try:
        jquant.set_mode('calib')
        calib = jax.jit(lambda v, *a: model.apply(
            v, *a, train=False, mutable=['quant'])[1])
        quant = jax.tree.map(np.asarray, calib(variables, *inputs)['quant'])
        jquant.set_mode('int8')
        apply = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
        out = apply({**variables, 'quant': quant}, *inputs)
    finally:
        jquant.set_mode('off')
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}
    anchors = JAX_MINI_CFG.pillars.anchors()
    cfg = JaxDecodeCfg()
    lmax = jnp.max(out['cls_score'][0].reshape(-1, 4), -1)
    idx = np.asarray(jax.lax.top_k(jax.nn.sigmoid(lmax),
                                   min(cfg.nms_pre, lmax.shape[0]))[1])
    cands = jax.tree.map(np.asarray, jax.jit(anchor_head_decode_candidates,
                                             static_argnums=4)(
        out['cls_score'][0], out['bbox_pred'][0], out['dir_pred'][0],
        anchors, cfg))

    sd = flax_to_torch(variables, PORT_MINI_CFG)
    launches = qconv3x3.launches
    predictor = Predictor(PORT_MINI_CFG, sd, device='cpu',
                          dtype=torch.float32,
                          quant_state=flax_quant_to_torch(quant,
                                                          PORT_MINI_CFG))
    port_out = {k: v.numpy() for k, v in predictor.forward(*inputs).items()}
    port_final = [t.numpy() for t in predictor(*inputs)]
    port_float = Predictor(PORT_MINI_CFG, sd, device='cpu',
                           dtype=torch.float32).forward(*inputs)
    port_quant = calibrate(PORT_MINI_CFG, sd, [inputs], device='cpu',
                           dtype=torch.float32)
    return dict(out=out, quant=quant, idx=idx, cands=cands, anchors=anchors,
                port_out=port_out, port_final=port_final,
                port_float={k: port_float[k].numpy() for k in KEYS},
                port_quant=port_quant,
                launches=qconv3x3.launches - launches)


@pytest.mark.parametrize('key', KEYS)
def test_int8_maps_match_jax(int8_outputs, key):
    got, want = int8_outputs['port_out'][key], int8_outputs['out'][key]
    assert_close_gain(got, want, TOL)
    float_gap = np.abs(int8_outputs['port_float'][key] - want).max()
    assert np.abs(got - want).max() < 0.5 * float_gap


def test_decoded_boxes_at_jax_indices(int8_outputs):
    po, anchors = int8_outputs['port_out'], int8_outputs['anchors']
    t = torch.from_numpy
    boxes, scores = decode_at(t(po['cls_score']), t(po['bbox_pred']),
                              t(po['dir_pred']), t(anchors),
                              torch.tensor(int8_outputs['idx'][None],
                                           dtype=torch.int64))
    want_boxes, want_scores = int8_outputs['cands']
    an = anchors.reshape(-1, 9)
    diag = float(np.sqrt(an[:, 3] ** 2 + an[:, 4] ** 2).max())
    gain = np.array([diag, diag, an[:, 5].max(), *want_boxes[:, 3:6].max(0),
                     1.0, diag, diag])
    err = np.abs(boxes[0].numpy() - want_boxes) / np.maximum(gain, 1.0)
    assert float(err.max()) < TOL, float(err.max())
    assert float(np.abs(scores[0].numpy() - want_scores).max()) < TOL


def test_predictor_outputs(int8_outputs):
    boxes, scores, labels, valid = int8_outputs['port_final']
    assert boxes.shape == (1, 500, 9) and scores.shape == (1, 500)
    assert labels.shape == valid.shape == (1, 500) and valid.sum() > 10
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()


def test_calibration_matches_jax(int8_outputs):
    """The port's own calibration records JAX's act_amax (up to f32
    summation order in the layers before each conv) and freezes every
    calibrated conv."""
    got, want = int8_outputs['port_quant'], flax_quant_to_torch(
        int8_outputs['quant'], PORT_MINI_CFG)
    amax = {k for k in got if k.endswith('.act_amax')}
    assert amax == set(want) and len(amax) == 94
    for k in amax:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
    assert len(got) == 3 * len(amax)


def test_cpu_path_launches_no_kernel(int8_outputs):
    assert int8_outputs['launches'] == 0
