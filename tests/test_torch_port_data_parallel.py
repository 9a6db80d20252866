"""Data-parallel training of the port (``omnihd_scenes_tpu_torch/parallel``)
on two ranks over gloo, in spawned processes, against one process and
against the JAX package's global-batch semantics.

One process group (``tests/torch_port_fixtures/dp_worker.py``, JAX-free)
runs every scenario; the references are computed here:

* the mini BEVFusion of ``tests/test_torch_port_train.py`` and its batch
  of 2, cut to two cameras and a ResNet18 trunk so that the file stays
  inside its time budget (seeded weights of ``serve/synthetic.py``), one
  f64 step with AdamW on one sample a rank, against the port's
  one-process step on the batch of 2 (the step ``test_torch_port_train.py``
  holds to JAX): the loss and its parts within 1e-9 relative, every
  gradient leaf after the reduction and the new BatchNorm statistics
  within 1e-9 of each leaf's max|ref| (the two BatchNorm biases whose
  exact gradient is 0 at a floor of 1e-6 of the largest leaf), the
  updated parameters within 1e-5 learning rates (AdamW divides each
  gradient by its magnitude); both ranks end bit-equal.  The control: the same two ranks with the BatchNorm and
  depth-loss reductions turned off (gradients still averaged) miss the
  one-process gradient by more than 1e-3 (the ASPP pool branch's
  BatchNorm sees one 1x1 map a rank, whose local variance is 0);
* the mini radar PointPillars of ``tests/test_torch_port_pointpillars.py``
  with dense pillars and one layer a SECOND block, one f64 step on one
  sample a rank against JAX's f64 step on the batch of 2 (JAX's gradient
  of a batch sharded over its CPU mesh equals the single-device one,
  ``tests/test_parallel.py``): the loss within 1e-6 relative and every
  gradient leaf within 1e-5 of its max|ref|, that file's limits.  JAX's
  gradient is jitted: with dense pillars it equals the eager one exactly
  (the jitted gradient through the sorted pillars' scatter is wrong on the
  CPU, ROADMAP queue 3 item 8, and the eager one compiles op by op for
  over 30 s);
* ``BatchNorm`` with a group against flax's train-mode BatchNorm on the
  concatenated batch (f64): output, input and parameter gradients, new
  running statistics within 1e-10, at one 1x1 map a rank and on a 3x5
  map;
* ``depth_dist_loss`` against JAX's on the global batch when one rank's
  mask is empty: the loss and the gradient within 1e-12 relative;
* ``collect_results`` over gloo against JAX's with its injected
  ``_allgather``: ragged counts, ``total_size``, and every rank raising
  when one holds no result.

The loaders need no process group (rank and world size are arguments):
the union of the ranks' ``TrainLoader`` rows per step equals JAX's
``TrainLoader`` global batch, with and without ``group_flags``; the
ranks' ``EvalLoader`` blocks reassemble the dataset in JAX's order; ranks
reseed their dataset's ``rng`` apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.data.loader import (EvalLoader as JaxEvalLoader,
                                           TrainLoader as JaxTrainLoader)
from omnihd_scenes_tpu.models.bevfusion import (
    depth_dist_loss as jax_depth_dist_loss)
from omnihd_scenes_tpu.models.detectors import PointPillars as JaxPointPillars
from omnihd_scenes_tpu.parallel.distributed import (
    _pad_local as jax_pad_local, collect_results as jax_collect_results)
from omnihd_scenes_tpu_torch.data.loader import EvalLoader, TrainLoader
from omnihd_scenes_tpu_torch.serve.synthetic import random_state_dict
from omnihd_scenes_tpu_torch.weights import flax_to_torch
from tests.test_torch_port_pointpillars import (CASES, assert_gradients_match,
                                                gt_batch, jax_f64_step,
                                                pillar_points,
                                                to_port_pillars)
from tests.test_torch_port_train import (DEPTH_RANGE, PORT_TRAIN_CFG,
                                         train_batch)
from tests.test_torch_port_weights import random_variables
from tests.torch_port_fixtures.dp_worker import run_ranks

torch.set_num_threads(1)

WORLD = 2
LR = 1e-3
FUSION_CFG = dataclasses.replace(PORT_TRAIN_CFG, num_views=2, resnet_depth=18)
CAMERA_KEYS = ('imgs', 'img2lidar_rots', 'img2lidar_trans', 'depth_gaussian',
               'depth_min')
BN_EPS = 1e-3
BN_SHAPES = {'1x1': (WORLD, 8, 1, 1), 'map': (2 * WORLD, 8, 3, 5)}
COLLECT = {'ragged': ([3, 2], None), 'trim': ([3, 3], 5), 'zero': ([2, 0],
                                                                   None)}


def _bn_case(shape):
    rng = np.random.RandomState(sum(shape))
    c = shape[1]
    return {'x': rng.randn(*shape) * rng.uniform(0.5, 3, (1, c, 1, 1))
            + rng.uniform(-2, 2, (1, c, 1, 1)),
            'weight': rng.uniform(0.5, 1.5, c), 'bias': rng.randn(c),
            'cotangent': rng.randn(*shape), 'eps': BN_EPS}


def _depth_case():
    """Depth distributions of 2 samples; sample 1 (rank 1) has no pixel in
    the camera's depth range."""
    rng = np.random.RandomState(7)
    pred = rng.uniform(0.01, 1, (WORLD, 6, 4, 5, 9))
    pred /= pred.sum(-1, keepdims=True)
    gt = rng.uniform(0, 1, pred.shape)
    gt /= gt.sum(-1, keepdims=True)
    d_min = rng.uniform(-1, 70, pred.shape[:-1])
    d_min[1] = 0.0
    return {'pred': pred, 'gt': gt, 'd_min': d_min,
            'depth_range': (1.0, 60.0, 1.0)}


def _fusion_batch():
    """``train_batch()`` on its first two cameras."""
    return {k: v[:, :FUSION_CFG.num_views] if k in CAMERA_KEYS else v
            for k, v in train_batch().items()}


def _pillar_case():
    jcfg, dims = CASES['radar-dense']
    jcfg = dataclasses.replace(jcfg, second_layer_nums=(1, 1, 1))
    pts, mask = pillar_points(5, dims)
    jax_model = JaxPointPillars(jcfg)
    variables = random_variables(jax_model, pts, mask, train=False)
    anchors = jcfg.anchors()
    batch = {'points': pts, 'points_mask': mask,
             **gt_batch(anchors, np.random.RandomState(9))}
    pcfg = to_port_pillars(jcfg)
    return jax_model, variables, pcfg, dims, anchors, batch


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    """Every scenario on two ranks (rank 0 also takes the one-process
    BEVFusion step), and JAX's pillar step."""
    fusion = {'cfg': FUSION_CFG,
              'state_dict': random_state_dict(FUSION_CFG, seed=0),
              'batch': _fusion_batch(),
              'anchors': FUSION_CFG.pillars.anchors(),
              'depth_range': DEPTH_RANGE, 'lr': LR}
    jax_model, variables, pcfg, dims, anchors, pbatch = _pillar_case()
    spec = {'bevfusion_step': fusion,
            'pillars_step': {'cfg': pcfg, 'dims': dims,
                             'state_dict': flax_to_torch(variables, pcfg),
                             'batch': pbatch, 'anchors': anchors},
            **{f'batch_norm:{k}': _bn_case(s) for k, s in BN_SHAPES.items()},
            'depth_loss': _depth_case(),
            **{f'collect:{k}': {'counts': c, 'total_size': t}
               for k, (c, t) in COLLECT.items()}}
    ranks = run_ranks(spec, str(tmp_path_factory.mktemp('dp')), WORLD)
    jax_pillars = jax_f64_step(jax_model, 'pointpillars', anchors, variables,
                               pbatch, pcfg)
    return {'ranks': ranks, 'jax_pillars': jax_pillars, 'spec': spec}


def test_bevfusion_step_matches_one_process(dp):
    """Loss and parts, gradients after the reduction, the new BatchNorm
    statistics and the parameters after AdamW against the one-process f64
    step on the same batch of 2; both ranks end bit-equal."""
    r0, r1 = (r['bevfusion_step'] for r in dp['ranks'])
    assert r0['digest'] == r1['digest']
    assert set(r0['scalars']) == set(r0['one_scalars'])
    for k, v in r0['one_scalars'].items():
        assert abs(r0['scalars'][k] - v) <= 1e-9 * abs(v), k
    assert r0['one_scalars']['loss_depth'] > 0
    assert r0['depth_conv_grad'] > 0
    bad = {k: e for k, e in r0['grad_errors'].items() if e > 1e-9}
    assert not bad, bad
    assert r0['stat_errors']
    bad = {k: e for k, e in r0['stat_errors'].items() if e > 1e-9}
    assert not bad, bad
    # AdamW's first step moves a parameter by lr * g / (|g| + 1e-8): a
    # gradient's last-bit difference moves it by up to lr * 1e-8 * |g|
    # / (|g| + 1e-8)^2, so the parameters are held in learning rates.
    assert r0['param_lr'] <= 1e-5, r0['param_lr']


def test_control_without_reductions_misses(dp):
    """With the BatchNorm and depth-loss reductions off, the averaged
    gradient misses the one-process gradient by more than 1e-3: the test
    above can fail."""
    errs = dp['ranks'][0]['bevfusion_step']['control_errors']
    assert max(errs.values()) > 1e-3, max(errs.values())


def test_pillars_step_matches_jax(dp):
    """The radar PointPillars' 2-rank f64 step against JAX's on the batch
    of 2: loss within 1e-6, every gradient leaf within 1e-5 of max|ref|;
    both ranks end bit-equal."""
    loss, grads = dp['jax_pillars']
    r0, r1 = (r['pillars_step'] for r in dp['ranks'])
    assert r0['loss'] == r1['loss'] and r0['digest'] == r1['digest']
    assert abs(r0['loss'] - loss) <= 1e-6 * abs(loss)
    assert_gradients_match(r0['grads'], grads)


def _flax_bn(case):
    """flax's train-mode BatchNorm (momentum 0.99) on the whole batch, in
    f64: y, d x, d scale, d bias of <y, cotangent>, new mean and var."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=case['eps'])
    with jax.enable_x64(True):
        x = jnp.asarray(np.moveaxis(case['x'], 1, -1))
        c = x.shape[-1]
        stats = {'mean': jnp.zeros(c), 'var': jnp.ones(c)}

        @jax.jit
        def run(x, scale, bias):
            return bn.apply({'params': {'scale': scale, 'bias': bias},
                             'batch_stats': stats}, x,
                            mutable=['batch_stats'])

        args = (x, jnp.asarray(case['weight']), jnp.asarray(case['bias']))
        y, new = run(*args)
        _, vjp = jax.vjp(lambda *a: run(*a)[0], *args)
        dx, dw, db = vjp(jnp.asarray(np.moveaxis(case['cotangent'], 1, -1)))
        return {'y': np.moveaxis(np.asarray(y), -1, 1),
                'dx': np.moveaxis(np.asarray(dx), -1, 1),
                'dweight': np.asarray(dw), 'dbias': np.asarray(db),
                'mean': np.asarray(new['batch_stats']['mean']),
                'var': np.asarray(new['batch_stats']['var'])}


@pytest.mark.parametrize('shape', list(BN_SHAPES))
def test_batch_norm_with_a_group_matches_flax(dp, shape):
    """Each rank's output and input-gradient rows, the parameters'
    gradients summed over the ranks and the running statistics (equal on
    both ranks) against flax on the concatenated batch."""
    want = _flax_bn(dp['spec'][f'batch_norm:{shape}'])
    got = [r[f'batch_norm:{shape}'] for r in dp['ranks']]
    merged = {'y': torch.cat([g['y'] for g in got]),
              'dx': torch.cat([g['dx'] for g in got]),
              'dweight': got[0]['dweight'] + got[1]['dweight'],
              'dbias': got[0]['dbias'] + got[1]['dbias'],
              'mean': got[0]['mean'], 'var': got[0]['var']}
    assert torch.equal(got[0]['mean'], got[1]['mean'])
    assert torch.equal(got[0]['var'], got[1]['var'])
    for k, w in want.items():
        err = float(np.abs(merged[k].numpy() - w).max())
        assert err <= 1e-10 * max(float(np.abs(w).max()), 1.0), (k, err)


def test_depth_loss_with_an_empty_rank_matches_jax(dp):
    """Rank 1 holds no pixel in range: the ranks' mean loss and their
    gradients equal JAX's loss on the global batch and its gradient."""
    case = dp['spec']['depth_loss']
    with jax.enable_x64(True):
        loss, grad = jax.value_and_grad(jax_depth_dist_loss)(
            jnp.asarray(case['pred']), jnp.asarray(case['gt']),
            jnp.asarray(case['d_min']), case['depth_range'])
    got = [r['depth_loss'] for r in dp['ranks']]
    assert got[0]['loss'] == got[1]['loss']
    assert abs(got[0]['loss'] - float(loss)) <= 1e-12 * float(loss)
    dpred = torch.cat([g['dpred'] for g in got]).numpy()
    assert np.abs(dpred - np.asarray(grad)).max() <= 1e-12 * np.abs(
        np.asarray(grad)).max()
    assert not np.any(dpred[1])


def _jax_collected(counts, total_size):
    locals_ = [[{'token': np.array([r * 100 + i]),
                 'boxes': np.full((4, 9), r * 100 + i, np.float32),
                 'valid': np.arange(3) < i} for i in range(n)]
               for r, n in enumerate(counts)]
    keys = ['boxes', 'token', 'valid']
    max_n = max(counts)

    def allgather(x):
        if isinstance(x, np.ndarray):
            return np.stack([np.asarray([c], np.int64) for c in counts])
        padded = [jax_pad_local(h, keys, max_n) for h in locals_]
        return {k: np.stack([p[k] for p in padded]) for k in x}

    try:
        return jax_collect_results(locals_[0], total_size,
                                   _allgather=allgather,
                                   _process_count=len(counts))
    except RuntimeError as e:
        return str(e)


@pytest.mark.parametrize('case', list(COLLECT))
def test_collect_results_matches_jax(dp, case):
    """Every rank gets JAX's list (ragged counts, trimmed to
    ``total_size``), or every rank raises when one holds nothing."""
    want = _jax_collected(*COLLECT[case])
    for r in dp['ranks']:
        got = r[f'collect:{case}']
        if isinstance(want, str):
            assert 'zero results' in got['error'] and 'zero' in want
            continue
        got = got['out']
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k])


class _Indices:
    """A dataset of its own indices."""

    def __init__(self, n):
        self.n = n
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'index': np.array(i)}


@pytest.mark.parametrize('grouped', [False, True])
def test_train_loader_ranks_make_jax_global_batches(grouped):
    """Per step, rank 0's rows then rank 1's are JAX's global batch of 4
    (every epoch, the padded tail included); ``len()`` counts global
    batches."""
    n = 23
    flags = np.random.RandomState(1).randint(0, 3, n) if grouped else None
    want = JaxTrainLoader(_Indices(n), 4, seed=2, group_flags=flags)
    ranks = [TrainLoader(_Indices(n), 4, seed=2, group_flags=flags, rank=r,
                         world_size=WORLD) for r in range(WORLD)]
    assert all(len(r) == len(want) for r in ranks)
    for epoch in range(2):
        for loader in (want, *ranks):
            loader.set_epoch(epoch)
        steps = list(zip(want, *ranks))
        assert len(steps) == len(want)
        for w, *parts in steps:
            assert all(len(p['index']) == 2 for p in parts)
            assert np.array_equal(
                np.concatenate([p['index'] for p in parts]), w['index'])


def test_train_loader_ranks_reseed_apart():
    """Without workers, rank r reseeds its dataset's rng as worker r
    would (ranks draw different augmentations); one rank leaves it."""
    one, r0, r1 = (_Indices(8) for _ in range(3))
    TrainLoader(one, 2)
    TrainLoader(r0, 2, rank=0, world_size=WORLD)
    TrainLoader(r1, 2, rank=1, world_size=WORLD)
    base = np.random.RandomState(0).randint(0, 2 ** 31 - 1)
    assert one.rng.randint(1 << 30) == np.random.RandomState(0).randint(
        1 << 30)
    assert r0.rng.randint(1 << 30) == np.random.RandomState(base).randint(
        1 << 30)
    assert r1.rng.randint(1 << 30) == np.random.RandomState(
        base + 1).randint(1 << 30)


@pytest.mark.parametrize('n, world', [(7, 2), (10, 4), (3, 4)])
def test_eval_loader_blocks_reassemble_jax_order(n, world):
    """The ranks' contiguous blocks (the last wrapped), in rank order and
    trimmed to n, are the dataset in JAX's ``EvalLoader`` order; each
    rank's batches hold its block's samples."""
    want = sorted(int(i) for b, v in JaxEvalLoader(_Indices(n), 2)
                  for i, ok in zip(b['index'], v) if ok)
    blocks = [EvalLoader(_Indices(n), 2, r, world) for r in range(world)]
    assert len({len(b.block) for b in blocks}) == 1
    assert np.concatenate([b.block for b in blocks])[:n].tolist() == want
    for b in blocks:
        seen = sorted(int(i) for batch, v in b
                      for i, ok in zip(batch['index'], v) if ok)
        assert seen == sorted(b.block.tolist())
