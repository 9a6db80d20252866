"""Export bundles of the port (``serve/export.py``) on the CPU.

* The mini PointPillars (``tests/test_torch_port_pointpillars.py:MINI``
  with dense pillars, the pillar encoder the serving configuration runs;
  its case ``radar-dense``) exported in f32 round-trips through its bundle and
  equals JAX's live forward plus ``anchor_head_get_bboxes`` on the same
  weights: the same kept rows, matched as multisets
  (``chip_smoke.py:kept_row_distance``), within 1e-5, as JAX's
  ``tests/test_export.py`` holds its own bundle.
* The mini BEVFusion with ResNet18 (``EXPORT_CFG``, as
  ``tests/test_torch_port_profile.py`` cuts it: tracing and loading a
  program take time by its nodes), from a fused checkpoint
  (``serve/fuse.py``), in bf16: it exports on the CPU; its graph calls the registered LSS op
  ``omnihd::lss_sample_bev`` once and holds nothing of the op's plain
  version (no node's stack reaches ``kernels/lss_sample.py``); and a
  fresh process loads it with a replaced ``weights.pt`` (the head's class
  bias + 0.5) and runs it with no ``omnihd_scenes_tpu_torch.models``
  module imported: its outputs are bit-equal to the live ``Predictor``'s
  on the replaced weights and differ from those on the bundle's own.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from chip_smoke import kept_row_distance
from omnihd_scenes_tpu.models.anchor_head import (
    DecodeCfg as JaxDecodeCfg, anchor_head_get_bboxes as jax_get_bboxes)
from omnihd_scenes_tpu.models.detectors import PointPillars as JaxPointPillars
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.serve.export import (META, PROGRAM, WEIGHTS,
                                                  export_model, load_exported)
from omnihd_scenes_tpu_torch.serve.fuse import fuse_model
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                     random_state_dict)
from omnihd_scenes_tpu_torch.weights import flax_to_torch, load_state_dict
from tests.test_torch_port_pointpillars import (MINI, pillar_points,
                                                to_port_pillars)
from tests.test_torch_port_weights import PORT_MINI_CFG, random_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The head's class bias: no BN follows it, so the fold leaves it as it is.
HEAD_BIAS = 'model.head.conv_cls.bias'
EXPORT_CFG = dataclasses.replace(PORT_MINI_CFG, resnet_depth=18)


def test_pointpillars_bundle_matches_jax(tmp_path):
    cfg = dataclasses.replace(MINI, pillar_impl='dense')
    pts, mask = pillar_points(5, 8, b=1)
    jax_model = JaxPointPillars(cfg)
    variables = random_variables(jax_model, pts, mask, train=False)
    anchors = cfg.anchors()

    @jax.jit
    def infer(v, p, m):
        raw = jax_model.apply(v, p, m, train=False)
        a = np.broadcast_to(anchors[None], (p.shape[0],) + anchors.shape)
        return jax.vmap(functools.partial(jax_get_bboxes,
                                          cfg=JaxDecodeCfg()))(
            raw['cls_score'], raw['bbox_pred'], raw['dir_pred'],
            np.ascontiguousarray(a, np.float32))

    want = [torch.from_numpy(np.array(x)) for x in infer(variables, pts,
                                                          mask)]
    pcfg = to_port_pillars(cfg)
    out = export_model(PointPillars(pcfg, 8), 'pointpillars',
                       flax_to_torch(variables, pcfg), (pts, mask),
                       str(tmp_path / 'bundle'), anchors=anchors, bf16=False,
                       device='cpu')
    assert set(os.listdir(out)) == {PROGRAM, WEIGHTS, META}
    loaded = load_exported(out, 'cpu')
    assert loaded.meta['mtype'] == 'pointpillars'
    assert [s['name'] for s in loaded.input_specs] == ['points',
                                                       'points_mask']
    got = loaded(pts, mask)
    for s in range(pts.shape[0]):
        assert int(got[3][s].sum()) == int(want[3][s].sum()) > 0
        assert kept_row_distance(list(got), want, s) < 1e-5


@pytest.fixture(scope='module')
def bevfusion(tmp_path_factory):
    """A fused mini BEVFusion checkpoint and its bf16 bundle, a copy of the
    bundle with a replaced weights.pt (the head's class bias + 0.5), and
    a fresh process that loads the copy, runs a request and reports what
    it imported, the program's graph and its outputs."""
    cfg = EXPORT_CFG
    model = BEVFusion(cfg)
    sd = random_state_dict(cfg, 2)
    rng = np.random.RandomState(7)
    for k in [k for k in sd if k.endswith('running_var')]:
        sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, sd[k].shape)
                                 .astype(np.float32))
        mk = k.replace('running_var', 'running_mean')
        sd[mk] = torch.from_numpy(rng.normal(0, 0.3, sd[mk].shape)
                                  .astype(np.float32))
    load_state_dict(model, sd)
    request = random_request(np.random.RandomState(8), cfg, 1,
                             n_points=512)
    t_request = [torch.from_numpy(x) for x in request]
    fused, report = fuse_model(model, lambda: model(*t_request),
                               verify=False)
    assert report['fused'] and not report['skipped']
    root = tmp_path_factory.mktemp('bevfusion')
    out = export_model(BEVFusion(cfg), 'bevfusion', fused, request,
                       str(root / 'bundle'), anchors=cfg.pillars.anchors(),
                       device='cpu')
    replaced = root / 'replaced'
    replaced.mkdir()
    for name in (PROGRAM, META):
        os.symlink(os.path.join(out, name), replaced / name)
    weights = torch.load(os.path.join(out, WEIGHTS))
    weights[HEAD_BIAS] = weights[HEAD_BIAS] + 0.5
    torch.save(weights, replaced / WEIGHTS)
    inputs, outputs = root / 'inputs.npz', root / 'outputs.pt'
    np.savez(inputs, *request)
    code = (
        'import sys, json, numpy as np, torch\n'
        'from omnihd_scenes_tpu_torch.serve.export import load_exported\n'
        f'model = load_exported({str(replaced)!r}, "cpu")\n'
        f'arrays = np.load({str(inputs)!r})\n'
        'out = model(*[arrays[f"arr_{i}"] for i in range(len(arrays))])\n'
        f'torch.save(list(out), {str(outputs)!r})\n'
        'nodes = list(model.program.graph.nodes)\n'
        'print(json.dumps({"models": sorted(m for m in sys.modules if '
        'm.startswith("omnihd_scenes_tpu_torch.models")), '
        '"jax": "jax" in sys.modules, '
        '"targets": [str(n.target) for n in nodes '
        'if n.op == "call_function"], '
        '"plain": [n.name for n in nodes if "kernels/lss_sample.py" in '
        'str(n.meta.get("stack_trace"))]}))\n')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                 out=torch.load(outputs))
    live = {}
    for name, bias in (('fused', 0.0), ('replaced', 0.5)):
        sd = dict(fused)
        key = HEAD_BIAS[len('model.'):]
        # weights.pt holds the bf16 bias: add where the bundle added.
        sd[key] = (sd[key].bfloat16() + bias).float()
        live[name] = Predictor(cfg, sd, device='cpu')(*request)
    return dict(out=out, child=child, live=live)


def test_bevfusion_bundle_calls_the_registered_op(bevfusion):
    targets = bevfusion['child']['targets']
    assert targets.count('omnihd.lss_sample_bev.default') == 1
    assert bevfusion['child']['plain'] == []
    meta = json.load(open(os.path.join(bevfusion['out'], META)))
    assert meta['bf16'] and meta['device'] == 'cpu'
    assert [(s['name'], s['dtype']) for s in meta['inputs']] == [
        ('points', 'float32'), ('points_mask', 'bool'),
        ('imgs', 'bfloat16'), ('rots', 'float32'), ('trans', 'float32')]


def test_bevfusion_bundle_equals_the_live_predictor(bevfusion):
    got, want = bevfusion['child']['out'], bevfusion['live']['replaced']
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_bundle_runs_without_model_code(bevfusion):
    child = bevfusion['child']
    assert child['models'] == [] and not child['jax']
    assert len(child['out']) == 4 and int(child['out'][3].sum()) > 0


def test_replaced_weights_are_served(bevfusion):
    got, live = bevfusion['child']['out'], bevfusion['live']
    assert not torch.equal(got[1], live['fused'][1])
    assert all(torch.equal(g, w) for g, w in zip(got, live['replaced']))
