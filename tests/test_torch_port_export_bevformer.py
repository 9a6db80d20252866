"""BEVFormer-T export bundles of the port (``serve/export.py``) on the CPU,
and the single-class rotated NMS (``ops/nms.py:nms_rotated``).

* ``configs/synthetic/bevformer_synth.py``'s model (at 64 x 96 images,
  here and below) on the JAX variables
  of ``tests/test_torch_port_bevformer.py`` (bridged by
  ``weights.flax_to_torch``): JAX's f32 export (``export_model(...,
  bf16=False, platforms=['cpu'])``, its anchor-less ``infer``) against
  the port's f32 bundle (``load_exported(dir, 'cpu')``) on two queue
  requests, one whose ``has_prev`` is mixed and one with a non-zero CAN
  bus: every output within 1e-4 of max|ref|.  The port's request carries
  a leading batch of 1, JAX's none.
* ``tools.export --device cpu`` of the synthetic config with DCNv2 on
  stages 3-4 (``--cfg-options``), from a fused checkpoint
  (``serve/fuse.py``, BN statistics drawn as in
  ``tests/test_torch_port_export.py``; the BNs after a DCN are not fused,
  as no conv produces their input), writes a bf16 bundle whose
  ``weights.pt`` keeps no passthrough BN (every one folded, none left to
  scale its input by 0.99771) and only the DCN stages' BNs, whose meta says ``decode`` None
  with the queue length and SCA cap and pins the input dtypes (ROADMAP
  queue 3 item 21: ``imgs_queue`` bf16, ``has_prev_queue`` bool, the CAN
  bus and ``lidar2img`` f32, where JAX's ``_to_bf16`` casts every f32
  input); a fresh process loads and runs it with no
  ``omnihd_scenes_tpu_torch.models`` module and no ``jax`` imported, and
  its outputs, in the live ``serving_model`` forward's dtypes, equal that
  forward's on the fused checkpoint in bf16, decoder layer by decoder
  layer (both processes on one thread);
* ROADMAP queue 3 item 22: a bf16 bundle of the mini model equals the
  live bf16 forward bit for bit in the BEV and in every decoder layer's
  scores and boxes, as JAX's bf16 export equals JAX's jitted bf16 forward
  of the same bridged weights on the same (bf16-cast) request; the port's
  exported program holds no ``scaled_dot_product_attention``, the
  operation whose backend the card picks per process and whose bf16
  results differed between a bundle's process and the live one.
* ``nms_rotated`` gives JAX's keep mask on seeded rotated boxes (two IoU
  tiles of JAX's, duplicated boxes, tied scores, a ``valid`` mask).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops.nms import nms_rotated as jax_nms_rotated
from omnihd_scenes_tpu.models.bevformer.detector import (
    BEVFormerDetector as JaxDetector)
from omnihd_scenes_tpu.serve.export import (
    _to_bf16 as jax_to_bf16, export_model as jax_export_model,
    load_exported as jax_load_exported)
from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
from omnihd_scenes_tpu_torch.ops import nms_rotated
from omnihd_scenes_tpu_torch.serve.export import (META, PROGRAM, WEIGHTS,
                                                  export_model, load_exported)
from omnihd_scenes_tpu_torch.serve.fuse import K, fuse_model
from omnihd_scenes_tpu_torch.serve.predictor import serving_model
from omnihd_scenes_tpu_torch.tools import export as export_cli
from omnihd_scenes_tpu_torch.train.builder import init_model
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_lidar2img
from omnihd_scenes_tpu_torch.weights import flax_to_torch, load_state_dict
from tests.test_torch_port_bevformer import (CFG, JCFG, assert_close,
                                             bridged_variables)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, 'configs', 'synthetic', 'bevformer_synth.py')
DCN = (False, False, True, True)
# The models here see a quarter of the synthetic config's pixels; the
# CLI test's has DCNv2 on stages 3-4.
IMG_HW = (64, 96)
MINI_CFG = dataclasses.replace(CFG, img_hw=IMG_HW)
MINI_JCFG = dataclasses.replace(JCFG, img_hw=IMG_HW)
DCN_CFG = dataclasses.replace(MINI_CFG, stage_with_dcn=DCN)
KEYS = ('bev_embed', 'all_cls_scores', 'all_bbox_preds')
# The bf16 bundle against the live bf16 forward: the same operations on
# the same weights, so the same bits (queue 3 item 22).
BF16_TOL = 0.0


def _requests():
    """Two queue requests of one stream (Q frames, no batch axis): the
    first with ``has_prev`` mixed and a zero CAN bus, the second with a
    CAN bus that shifts and turns the BEV."""
    rng = np.random.RandomState(3)
    q, n = CFG.queue_length, CFG.num_cams
    l2i = np.stack([ring_rig_lidar2img(img_hw=IMG_HW) * (1 + 0.01 * i)
                    for i in range(q)]).astype(np.float32)
    out = []
    for has_prev, moving in (([True, False], False), ([False, True], True)):
        cbs = np.zeros((q, 18), np.float32)
        if moving:
            cbs[:, :2] = rng.uniform(-1.5, 1.5, (q, 2))
            cbs[:, -2] = rng.uniform(0.0, 2 * np.pi, q)
            cbs[:, -1] = rng.uniform(-4.0, 4.0, q)
        imgs = rng.randn(q, n, *IMG_HW, 3).astype(np.float32)
        out.append((imgs, cbs, l2i, np.array(has_prev[:q])))
    return out


def test_f32_bundle_matches_jax_export(tmp_path):
    cfg = MINI_CFG
    variables = bridged_variables(cfg)
    requests = _requests()
    jax_dir = jax_export_model(JaxDetector(MINI_JCFG), 'bevformer', variables,
                               requests[0], str(tmp_path / 'jax'),
                               bf16=False, platforms=['cpu'])
    jax_model = jax_load_exported(jax_dir)
    port_dir = export_model(BEVFormerDetector(cfg), 'bevformer',
                            flax_to_torch(variables, cfg),
                            tuple(x[None] for x in requests[0]),
                            str(tmp_path / 'port'), bf16=False, device='cpu')
    meta = json.load(open(os.path.join(port_dir, META)))
    assert meta['decode'] is None and not meta['bf16']
    port = load_exported(port_dir, 'cpu')
    for request in requests:
        want = jax_model(*request)
        got = port(*(x[None] for x in request))
        assert sorted(got) == sorted(want) == sorted(KEYS)
        for k in KEYS:
            assert got[k].dtype == torch.float32
            assert_close(got[k][0], np.asarray(want[k]))


def _fused_checkpoint(tmp_path):
    """A fused checkpoint of the synthetic model with DCNv2 (seeded
    weights, drawn BN statistics) as ``tools.train`` saves one, and the
    export CLI's example queue."""
    model = init_model(BEVFormerDetector(DCN_CFG),
                       torch.Generator().manual_seed(0)).eval()
    sd = model.state_dict()
    rng = np.random.RandomState(7)
    for k in [k for k in sd if k.endswith('running_var')]:
        sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, sd[k].shape)
                                 .astype(np.float32))
        mk = k.replace('running_var', 'running_mean')
        sd[mk] = torch.from_numpy(rng.normal(0, 0.3, sd[mk].shape)
                                  .astype(np.float32))
    load_state_dict(model, sd)
    request = export_cli.example_inputs(model, 'bevformer')
    queue = [torch.from_numpy(x) for x in request]
    fused, report = fuse_model(model, lambda: model(*queue), verify=False)
    assert report['fused']
    path = tmp_path / 'fused.pt'
    torch.save({'model': fused}, path)
    return fused, request, str(path)


def test_export_cli_fused_bundle_in_a_fresh_process(tmp_path):
    fused, request, ckpt = _fused_checkpoint(tmp_path)
    out = str(tmp_path / 'bundle')
    assert export_cli.main([
        SYNTH, ckpt, '--out', out, '--device', 'cpu', '--cfg-options',
        f'model.stage_with_dcn={DCN}', f'model.img_hw={IMG_HW}']) == out
    meta = json.load(open(os.path.join(out, META)))
    assert meta['mtype'] == 'bevformer' and meta['bf16']
    assert meta['decode'] is None
    assert (meta['queue_length'], meta['sca_query_cap']) == (
        CFG.queue_length, CFG.sca_query_cap)
    assert [(s['name'], s['dtype']) for s in meta['inputs']] == [
        ('imgs_queue', 'bfloat16'), ('can_bus_queue', 'float32'),
        ('lidar2img_queue', 'float32'), ('has_prev_queue', 'bool')]
    weights = torch.load(os.path.join(out, WEIGHTS))
    left = {k.rsplit('.', 1)[0] for k in weights if 'running_var' in k}
    assert left and all('layer3' in k or 'layer4' in k for k in left)
    for name in left:                          # none is a passthrough
        assert not bool((weights[name + '.weight'] == K).all())
    inputs, outputs = tmp_path / 'inputs.npz', tmp_path / 'outputs.pt'
    np.savez(inputs, *request)
    code = (
        'import sys, json, numpy as np, torch\n'
        'torch.set_num_threads(1)\n'
        'from omnihd_scenes_tpu_torch.serve.export import load_exported\n'
        f'model = load_exported({out!r}, "cpu")\n'
        f'arrays = np.load({str(inputs)!r})\n'
        'out = model(*[arrays[f"arr_{i}"] for i in range(len(arrays))])\n'
        f'torch.save(dict(out), {str(outputs)!r})\n'
        'print(json.dumps({"models": sorted(m for m in sys.modules if '
        'm.startswith("omnihd_scenes_tpu_torch.models")), '
        '"jax": "jax" in sys.modules}))\n')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child['models'] == [] and not child['jax']
    got = torch.load(outputs)
    model = BEVFormerDetector(DCN_CFG)
    load_state_dict(model, fused)
    live = serving_model(model, 'cpu', torch.bfloat16, lambda: request)
    with torch.no_grad():
        want = live(torch.from_numpy(request[0]).bfloat16(),
                    *(torch.from_numpy(x) for x in request[1:]))
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        for g, w in _by_layer(k, got[k][0], want[k][0]):
            assert_close(g.float(), w.float(), BF16_TOL)


def _by_layer(key, got, want):
    """(got, want) pairs of one output of a request (no batch axis): the
    BEV whole, the scores and boxes one decoder layer at a time."""
    if key == 'bev_embed':
        return [(got, want)]
    return list(zip(got, want))


def test_bf16_bundle_decoder_layers_equal_the_live_forward(tmp_path):
    """Queue 3 item 22, pinned on both sides at the mini config."""
    cfg = MINI_CFG
    variables = bridged_variables(cfg)
    requests = _requests()
    port_dir = export_model(BEVFormerDetector(cfg), 'bevformer',
                            flax_to_torch(variables, cfg),
                            tuple(x[None] for x in requests[0]),
                            str(tmp_path / 'port'), bf16=True, device='cpu')
    program = torch.export.load(os.path.join(port_dir, PROGRAM))
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == 'call_function'}
    assert not [op for op in ops if 'scaled_dot_product' in op], ops
    port = load_exported(port_dir, 'cpu')
    model = BEVFormerDetector(cfg)
    load_state_dict(model, flax_to_torch(variables, cfg))
    live = serving_model(model, 'cpu', torch.bfloat16, lambda: requests[0])

    jax_dir = jax_export_model(JaxDetector(MINI_JCFG), 'bevformer',
                               variables, requests[0], str(tmp_path / 'jax'),
                               bf16=True, platforms=['cpu'])
    jax_bundle = jax_load_exported(jax_dir)
    jax_model = JaxDetector(MINI_JCFG)
    jax_vars = jax_to_bf16({'params': variables['params'],
                            'batch_stats': variables.get('batch_stats', {})})
    jax_live = jax.jit(lambda p, s, *a: jax_model.apply(
        {'params': p, 'batch_stats': s}, *a, train=False))
    for request in requests:
        got = port(*(x[None] for x in request))
        with torch.no_grad():
            want = live(torch.from_numpy(request[0][None]).bfloat16(),
                        *(torch.from_numpy(x[None]) for x in request[1:]))
        cast = tuple(jax_to_bf16(x) for x in request)
        jax_got = jax_bundle(*cast)
        jax_want = jax_live(jax_vars['params'], jax_vars['batch_stats'],
                            *cast)
        for k in KEYS:
            assert got[k].dtype == want[k].dtype, k
            pairs = (_by_layer(k, got[k][0].float(), want[k][0].float())
                     + _by_layer(k, np.asarray(jax_got[k], np.float32),
                                 np.asarray(jax_want[k], np.float32)))
            assert len(pairs) == (2 if k == 'bev_embed'
                                  else 2 * CFG.decoder_layers)
            for g, w in pairs:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('use_valid', [False, True])
def test_nms_rotated_matches_jax(use_valid):
    rng = np.random.RandomState(5)
    n = 200
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(-6, 6, (n, 2))
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform(0.5, 3.0, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[150:170] = boxes[:20]                       # duplicates
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[100:140] = scores[60:100]                  # ties
    scores[150:160] = scores[:10]
    valid = rng.uniform(size=n) > 0.2 if use_valid else None
    want = np.asarray(jax.jit(jax_nms_rotated, static_argnums=2)(
        boxes, scores, 0.2, valid))
    got = nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2,
                      None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(want.sum()) < (n if valid is None else int(valid.sum()))
    batched = nms_rotated(torch.from_numpy(np.stack([boxes, boxes[::-1]])),
                          torch.from_numpy(np.stack([scores, scores[::-1]])),
                          0.2)
    if valid is None:
        assert torch.equal(batched[0], got)
