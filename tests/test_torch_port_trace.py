"""The program's spans and counters (``utils/timing.py``) on the CPU, at
the mini configurations: switching the spans on changes no output of
``Predictor``, ``StreamPredictor`` or a train step; switched off they
record nothing and enter no profiler range; switched on every stage span
is recorded once a call, under its parent, with its root's request id;
``torch.profiler`` and ``device_trace``'s Chrome trace see the
``omnihd.*`` ranges; ``torch.export`` exports the same program either
way; the counters count what the program does."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.config import BEVFormerConfig
from omnihd_scenes_tpu_torch.kernels import launch_counts
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
    multi_scale_deformable_attn)
from omnihd_scenes_tpu_torch.serve.predictor import (Predictor,
                                                     StreamPredictor)
from omnihd_scenes_tpu_torch.serve.synthetic import (
    random_bevformer_state_dict, random_request, random_state_dict,
    random_stream_frame, random_train_batch)
from omnihd_scenes_tpu_torch.train.amp import bf16_policy
from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                make_train_step)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)
from omnihd_scenes_tpu_torch.utils import timing
from tests.test_torch_port_weights import PORT_MINI_CFG

torch.set_num_threads(1)

STREAM_CFG = BEVFormerConfig(bev_h=8, bev_w=12, num_query=16, embed_dims=32,
                             encoder_layers=1, decoder_layers=1, num_cams=2,
                             resnet_depth=18, img_hw=(64, 96))
TRAIN_CFG = dataclasses.replace(
    PORT_MINI_CFG, resnet_depth=18,
    pillars=dataclasses.replace(PORT_MINI_CFG.pillars, pillar_impl='sorted'))

# Each stage span of a call and the span it opens under.
PARENTS = {
    'serve': {
        'serve.request': None,
        'serve.upload': 'serve.request',
        'serve.check_rotations': 'serve.upload',
        'bevfusion.pillars': 'serve.request',
        'bevfusion.second': 'serve.request',
        'bevfusion.secondfpn': 'serve.request',
        'bevfusion.resnet': 'serve.request',
        'bevfusion.fpnc': 'serve.request',
        'bevfusion.lss': 'serve.request',
        'lss.depthnet': 'bevfusion.lss',
        'lss.splat': 'bevfusion.lss',
        'lss.bevencode': 'bevfusion.lss',
        'bevfusion.fuse_head': 'serve.request',
        'serve.decode': 'serve.request',
        'decode.candidates': 'serve.decode',
        'decode.nms': 'serve.decode'},
    'stream': {
        'stream.request': None,
        'stream.upload': 'stream.request',
        'bevformer.backbone': 'stream.request',
        'bevformer.encoder': 'stream.request',
        'bevformer.decoder': 'stream.request',
        'stream.decode': 'stream.request'},
    'train': {
        'train.step': None,
        'train.forward_loss': 'train.step',
        'bevfusion.pillars': 'train.forward_loss',
        'bevfusion.second': 'train.forward_loss',
        'bevfusion.secondfpn': 'train.forward_loss',
        'bevfusion.resnet': 'train.forward_loss',
        'bevfusion.fpnc': 'train.forward_loss',
        'bevfusion.lss': 'train.forward_loss',
        'lss.depthnet': 'bevfusion.lss',
        'lss.splat': 'bevfusion.lss',
        'lss.bevencode': 'bevfusion.lss',
        'bevfusion.fuse_head': 'train.forward_loss',
        'train.loss': 'train.forward_loss',
        'train.backward': 'train.step',
        'train.optimizer': 'train.step'},
}
# MSDA calls a stream frame of STREAM_CFG: one encoder layer's TSA and
# its SCA once a camera, one decoder layer's cross-attention.
MSDA_A_FRAME = 1 + 2 + 1


@pytest.fixture(autouse=True)
def spans_off():
    timing.enable(False)
    timing.reset(setup=True)
    yield
    timing.enable(False)
    timing.reset(setup=True)


@pytest.fixture(scope='module')
def serve():
    predictor = Predictor(PORT_MINI_CFG, random_state_dict(PORT_MINI_CFG, 5),
                          device='cpu', dtype=torch.float32)
    rng = np.random.RandomState(5)
    requests = [random_request(rng, PORT_MINI_CFG, batch=2, n_points=600)
                for _ in range(2)]
    return lambda i: predictor(*requests[i])


@pytest.fixture(scope='module')
def stream():
    predictor = StreamPredictor(STREAM_CFG,
                                random_bevformer_state_dict(STREAM_CFG, 1),
                                device='cpu', dtype=torch.float32)
    rng = np.random.RandomState(0)
    frames = [random_stream_frame(rng, STREAM_CFG, 2) for _ in range(2)]
    bev = predictor.zero_bev(2)
    has_prev = np.array([False, True])
    return lambda i: predictor(*frames[i], bev, has_prev)


@pytest.fixture(scope='module')
def train():
    """A fresh train state a call of the returned ``run(i)``: the same
    step on the same batch from the same weights."""
    sd = random_state_dict(TRAIN_CFG, 6)
    rng = np.random.RandomState(6)
    batches = [{k: torch.from_numpy(v) for k, v in random_train_batch(
        rng, TRAIN_CFG, 2, n_points=400, max_gt=6).items()}
        for _ in range(2)]

    def run(i):
        model = BEVFusion(TRAIN_CFG)
        model.load_state_dict(sd)
        state = create_train_state(model, lambda p: make_optimizer(
            p, make_lr_schedule(1e-3, 10)))
        fn = make_loss_fn_generic(
            model, 'bevfusion', TRAIN_CFG.pillars.anchors(),
            camera_depth_range=TRAIN_CFG.lss.camera_depth_range)
        _, loss, aux = make_train_step(bf16_policy(fn))(state, batches[i])
        return loss, aux['grad_norm'], model.state_dict()
    return run


def _leaves(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


@pytest.mark.parametrize('path', ['serve', 'stream', 'train'])
def test_outputs_bit_equal_with_spans_on_and_off(path, request):
    run = request.getfixturevalue(path)
    off = _leaves(run(0))
    timing.enable(True)
    on = _leaves(run(0))
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert {r.name for r in timing.records()} >= set(PARENTS[path])


@pytest.mark.parametrize('path', ['serve', 'stream', 'train'])
def test_each_stage_once_a_call_under_its_parent(path, request):
    run = request.getfixturevalue(path)
    run(0)                                  # warm-up, spans off
    msda = multi_scale_deformable_attn.calls
    timing.reset()
    timing.enable(True)
    for i in range(2):
        run(i)
    recs = [r for r in timing.records() if not r.name.startswith('setup.')]
    got = timing.collect()
    by_id = {r.span_id: r for r in recs}
    for name, parent in PARENTS[path].items():
        assert got['spans'][name]['calls'] == 2, name
    roots = [r for r in recs if r.parent_id is None]
    assert [r.name for r in roots] == [
        n for n, p in PARENTS[path].items() if p is None] * 2
    assert len({r.request_id for r in roots}) == 2
    for r in recs:
        if r.parent_id is None:
            assert r.request_id == r.span_id
            continue
        parent = by_id[r.parent_id]
        assert r.request_id == parent.request_id
        assert parent.t0 <= r.t0 <= r.t1 <= parent.t1
        if r.name in PARENTS[path]:
            assert parent.name == PARENTS[path][r.name], r.name
    for name, v in got['spans'].items():
        assert 0 <= v['self_device_ms'] <= v['device_ms'], name
        assert v['device_ms'] == v['host_ms']       # the CPU: no events
    calls = multi_scale_deformable_attn.calls - msda
    assert got['spans'].get('msda', {'calls': 0})['calls'] == calls
    assert calls == (2 * MSDA_A_FRAME if path == 'stream' else 0)
    if path == 'serve':
        assert got['counters']['serve.requests'] == 2
        assert got['counters']['serve.samples'] == 4


def test_spans_off_record_nothing_and_enter_no_range(serve, monkeypatch):
    entered = []

    class Refused:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', Refused)
    serve(0)
    assert timing.records() == [] and entered == []
    assert timing.collect()['spans'] == {}


def test_set_up_spans_record_while_spans_are_off():
    Predictor(PORT_MINI_CFG, random_state_dict(PORT_MINI_CFG, 5),
              device='cpu', dtype=torch.float32)
    assert not timing.enabled()
    names = ['setup.build', 'setup.load_state_dict', 'setup.to_device']
    spans = timing.collect()['spans']
    assert sorted(spans) == sorted(names)
    assert all(spans[n]['calls'] == 1 and spans[n]['host_ms'] > 0
               for n in names)
    timing.reset()
    assert sorted(timing.collect()['spans']) == sorted(names)
    timing.reset(setup=True)
    assert timing.collect()['spans'] == {}


def test_profiler_holds_the_ranges(serve):
    from torch.profiler import ProfilerActivity, profile

    timing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(0)
    names = {e.name for e in prof.events()}
    want = {timing.PREFIX + n for n in PARENTS['serve']}
    assert want <= names, want - names


def test_device_trace_holds_the_ranges(stream, tmp_path):
    with timing.device_trace(str(tmp_path / 'trace')):
        stream(0)
    assert not timing.enabled()
    files = os.listdir(tmp_path / 'trace')
    trace = json.loads((tmp_path / 'trace' / files[0]).read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    for name in list(PARENTS['stream']) + ['msda']:
        assert timing.PREFIX + name in names, name


def test_export_is_the_same_program_with_spans_on_and_off(tmp_path):
    """The mini PointPillars bundle (decode + NMS inside the program),
    exported with spans off and on: the same graph, and no span opened
    while ``torch.export`` traced (the upload runs before the trace)."""
    from omnihd_scenes_tpu_torch.models.detectors import PointPillars
    from omnihd_scenes_tpu_torch.serve.export import (export_model,
                                                      load_exported)
    from tests.test_torch_port_pointpillars import (MINI, pillar_points,
                                                    to_port_pillars)

    cfg = to_port_pillars(dataclasses.replace(MINI, pillar_impl='dense'))
    pts, mask = pillar_points(5, 8, b=1)
    sd = PointPillars(cfg, 8).state_dict()
    codes = []
    for on in (False, True):
        timing.enable(on)
        out = export_model(PointPillars(cfg, 8), 'pointpillars', sd,
                           (pts, mask), str(tmp_path / str(on)),
                           anchors=cfg.anchors(), bf16=False, device='cpu')
        timing.enable(False)
        codes.append(load_exported(out, 'cpu').program.graph_module.code)
    assert {r.name for r in timing.records()} == {'serve.upload'}
    assert codes[0] == codes[1]
    assert 'record_function' not in codes[1]
    assert 'profiler' not in codes[1]


def test_upload_bytes_count_the_inputs():
    request = random_request(np.random.RandomState(9), PORT_MINI_CFG,
                             batch=1, n_points=300)
    predictor = Predictor(PORT_MINI_CFG, random_state_dict(PORT_MINI_CFG, 5),
                          device='cpu', dtype=torch.float32)
    timing.reset()
    predictor(*request)
    assert timing.collect()['counters']['serve.upload_bytes'] == sum(
        x.nbytes for x in request)


def test_launch_counts_name_every_counted_entry():
    counts = launch_counts()
    assert {'lss_sample_bev', 'lss_sample_bev_backward', 'lss_sample',
            'msda', 'lss_splat', 'rectify_footprint',
            'rectify_taps'} <= set(counts)
    assert counts['msda'] == multi_scale_deformable_attn.calls


def test_a_recomputed_forward_is_counted_under_the_backward():
    """A span inside a checkpointed function opens in the forward and not
    in the backward's recomputation: that time is its caller's."""
    from torch.utils.checkpoint import checkpoint

    inner = timing.span('test.inner')

    @inner
    def f(x):
        return torch.sin(x) * x

    x = torch.randn(8, requires_grad=True)
    timing.enable(True)
    with timing.span('test.step'):
        y = checkpoint(f, x, use_reentrant=False).sum()
        with timing.span('test.backward'):
            y.backward()
    spans = timing.collect()['spans']
    assert spans['test.inner']['calls'] == 1
    assert spans['test.backward']['calls'] == 1
    step = [r for r in timing.records() if r.name == 'test.step'][0]
    assert {r.request_id for r in timing.records()} == {step.span_id}


def test_self_time_is_device_time_less_the_children():
    timing.enable(True)
    with timing.span('test.root'):
        for _ in range(3):
            with timing.span('test.child'):
                torch.randn(64, 64) @ torch.randn(64, 64)
    s = timing.collect()['spans']
    root, child = s['test.root'], s['test.child']
    assert child['calls'] == 3 and child['self_device_ms'] == pytest.approx(
        child['device_ms'])
    assert root['self_device_ms'] == pytest.approx(
        root['device_ms'] - child['device_ms'])
    assert timing.children_ms('test.root') == {
        'test.child': pytest.approx(child['device_ms']),
        'test.root': pytest.approx(root['device_ms'])}
