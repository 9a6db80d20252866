"""One training step of the port against the JAX package at the mini
configuration of ``tests/test_full_graph_parity.py`` in its training
modes (``pillar_impl='sorted'``, ``splat_mode='sample'``), batch 2, with
the depth-distribution loss, against jitted JAX
``jax.value_and_grad(make_loss_fn_generic(...))``:

* the loss and its parts: the port's f32 within 1e-5 relative of JAX's
  f64 (JAX under ``jax.enable_x64``), the port's f64 within 1e-6;
* every gradient leaf within 1e-5 of its own max|ref| with both packages
  in f64: the same function, on the conditioned weights below and on the
  mini variables as drawn, where about half the BatchNorm outputs are
  below 0, so the ReLU masks of the BN -> ReLU blocks (PFN, SECOND, FPN,
  ASPP, ResNet) clip and their gradient is held to JAX;
* the port's f32 gradients within 1e-2 of that f64 gradient in every
  leaf, and at their worst no further off than flax's own f32 ones;
* the port's new f32 BatchNorm statistics within 1e-4 of max|ref| of
  JAX's f64 ones (the frozen backbone's unchanged).

Why the reference is JAX in f64: flax's BatchNorm computes its variance
as E[x^2] - E[x]^2 and differentiates that form, which loses most of its
digits where a channel's mean dwarfs its spread.  The ASPP global-pool
branch normalises 12 per-image averages that differ little, so flax's f32
gradients of the camera trunk were up to 2.6e-2 off its own f64 ones
where the port's (two-pass variance) were within 1.2e-3, and its f32 loss
and statistics ~1e-5 off (CPU; the f64 runs agree to ~1e-6).  Two more f32 effects are kept small by the batch and the
weights: a ReLU input within a rounding of 0 takes the other branch in
the other package (for the f32 comparisons, BatchNorm biases near +4
keep ReLU inputs off 0, and
the frozen backbone's running statistics are set to its batch statistics
on these images so that its activations stay O(1)); images scaled per
camera make the pooled averages differ.  Two BatchNorm biases have an
exact gradient of 0 (a train-mode BatchNorm behind them removes any
shift): they are compared at a floor of the largest leaf's scale.

The rest:

* the bf16 policy casts the same set of parameters and batch entries as
  ``train/amp.py``;
* on identical gradients, clip + AdamW + schedule equal optax within
  1e-6 over 3 steps, clipped and not;
* a checkpoint round-trips bit-equal, rotated to the last 3.

JAX's gradient is compiled twice (f32 and f64) in one module fixture;
the file takes about 4 minutes on one CPU (ResNet50 at production widths
on twelve 64x112 images, six times).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnihd_scenes_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from omnihd_scenes_tpu.train import amp as jax_amp
from omnihd_scenes_tpu.train.builder import (
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu.train.optim import (
    make_lr_schedule as jax_make_lr_schedule,
    make_optimizer as jax_make_optimizer)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.layers import BatchNorm
from omnihd_scenes_tpu_torch.train import amp
from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
from omnihd_scenes_tpu_torch.train.loop import (JsonLogger,
                                                create_train_state,
                                                load_checkpoint,
                                                make_train_step,
                                                run_training,
                                                save_checkpoint)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)
from omnihd_scenes_tpu_torch.weights import (flax_to_torch,
                                             flax_tree_to_torch,
                                             load_state_dict, torch_to_flax)
from tests.test_full_graph_parity import FUSION_CFG
from tests.test_torch_port_weights import (mini_inputs, mini_variables,
                                           to_port_config)

torch.set_num_threads(1)

JAX_TRAIN_CFG = dataclasses.replace(
    FUSION_CFG, lss=dataclasses.replace(FUSION_CFG.lss, splat_mode='sample'))
PORT_TRAIN_CFG = to_port_config(JAX_TRAIN_CFG)
DEPTH_RANGE = JAX_TRAIN_CFG.lss.camera_depth_range


def train_batch():
    """Batch 2: the mini inputs and a second sample; GT boxes near the
    anchors (with padded rows), depth targets with unobserved pixels."""
    pts, mask, imgs, rots, trans = mini_inputs()
    rng = np.random.RandomState(31)
    pts2 = pts.copy()
    pts2[..., :2] = rng.uniform(-7, 7, pts2[..., :2].shape)
    anchors = JAX_TRAIN_CFG.pillars.anchors().reshape(-1, 9)
    g = 8
    boxes = anchors[rng.choice(len(anchors), (2, g))].copy()
    boxes[..., :3] += rng.uniform(-0.3, 0.3, (2, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, g))
    gt_mask = np.ones((2, g), bool)
    gt_mask[:, -2:] = False
    f_h, f_w = JAX_TRAIN_CFG.lss.feat_hw
    d_bins = JAX_TRAIN_CFG.lss.depth_bins
    gauss = rng.uniform(size=(2, 6, f_h, f_w, d_bins)).astype(np.float32)
    gauss /= gauss.sum(-1, keepdims=True)
    d_min = rng.uniform(-1, 11, (2, 6, f_h, f_w)).astype(np.float32)
    imgs = np.concatenate([imgs, rng.randn(*imgs.shape).astype(np.float32)])
    imgs = (imgs * np.exp(rng.uniform(-2, 1.2, (2, 6, 1, 1, 1)))
            + rng.uniform(-3, 3, (2, 6, 1, 1, 3))).astype(np.float32)
    return {'points': np.concatenate([pts, pts2]),
            'points_mask': np.concatenate([mask, mask]),
            'imgs': imgs,
            'img2lidar_rots': np.concatenate([rots, rots]),
            'img2lidar_trans': np.concatenate([trans, trans]),
            'gt_boxes': boxes.astype(np.float32),
            'gt_labels': rng.randint(0, 4, (2, g)).astype(np.int32),
            'gt_mask': gt_mask, 'depth_gaussian': gauss, 'depth_min': d_min}


def _condition(tree, path=()):
    """BatchNorm scales near 1 and biases near +4: ReLU inputs sit away
    from 0."""
    if isinstance(tree, dict):
        return {k: _condition(v, path + (k,)) for k, v in tree.items()}
    v = np.asarray(tree)
    if path[0] == 'params' and path[-2].startswith('BatchNorm'):
        v = 1 + 2 * v if path[-1] == 'scale' else 4 + v
    return v.astype(np.float32)


def train_variables(batch):
    """The mini variables, conditioned, with the frozen backbone's running
    statistics set to its batch statistics on ``batch``'s images."""
    variables = _condition(mini_variables())
    cal = BEVFusion(dataclasses.replace(PORT_TRAIN_CFG,
                                        frozen_backbone_bn=False))
    sd = flax_to_torch(variables, PORT_TRAIN_CFG)
    load_state_dict(cal, sd)
    cal = cal.double().train()
    stats = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: stats.__setitem__(
            name, torch.var_mean(args[0], (0, 2, 3), correction=0)))
        for name, m in cal.resnet.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    imgs = torch.from_numpy(batch['imgs']).double()
    with torch.no_grad():
        cal.resnet(imgs.flatten(0, 1).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    for name, (var, mean) in stats.items():
        sd[f'resnet.{name}.running_mean'] = mean.float()
        sd[f'resnet.{name}.running_var'] = var.float()
    return torch_to_flax(sd, PORT_TRAIN_CFG)


def _torch(tree, collection):
    """A flax collection in torch names, f64 (after the bridge's f32 cast,
    6e-8 relative: far inside every tolerance here)."""
    return {k: v.double() for k, v in flax_tree_to_torch(
        tree, PORT_TRAIN_CFG, collection).items()}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(
        a).dtype == np.float32 else np.asarray(a), tree)


def _port_step(variables, batch, dtype):
    """(loss, aux, new running statistics, gradients, share of BatchNorm
    outputs below 0) of the port."""
    port = BEVFusion(PORT_TRAIN_CFG)
    load_state_dict(port, flax_to_torch(variables, PORT_TRAIN_CFG))
    port = port.to(dtype).train()
    counts = torch.zeros(2, dtype=torch.float64)

    def count(module, args, out):
        counts.add_(torch.tensor([float((out < 0).sum()), out.numel()]))

    for m in port.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(count)
    loss_fn = make_loss_fn_generic(port, 'bevfusion',
                                   PORT_TRAIN_CFG.pillars.anchors(),
                                   camera_depth_range=DEPTH_RANGE)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in t_batch.items()}
    loss, aux = loss_fn(port, None, t_batch)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in aux.items()},
            {k: v.double() for k, v in port.state_dict().items()
             if 'running' in k},
            {k: p.grad.double() for k, p in port.named_parameters()},
            float(counts[0] / counts[1]))


@pytest.fixture(scope='module')
def step():
    """Loss, aux, new statistics and gradients of JAX in f32 and f64 and of
    the port in f32 and f64, on the same weights and batch; and of both in
    f64 on the mini variables as drawn (``*_raw``)."""
    batch = train_batch()
    variables = train_variables(batch)
    raw = jax.tree.map(lambda a: np.asarray(a, np.float32), mini_variables())
    loss_fn = jax_make_loss_fn(JaxBEVFusion(JAX_TRAIN_CFG), 'bevfusion',
                               JAX_TRAIN_CFG.pillars.anchors(),
                               camera_depth_range=DEPTH_RANGE)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def jax_step(variables):
        (loss, (aux, stats)), grads = grad_fn(*_f64(
            (variables['params'], variables['batch_stats'], batch)))
        return (float(loss), {k: float(v) for k, v in aux.items()},
                _torch(stats, 'batch_stats'), _torch(grads, 'params'))

    out = {}
    with jax.enable_x64(False):
        out['jax32'] = jax_step(variables)
    with jax.enable_x64(True):
        out['jax64'] = jax_step(variables)
        out['jax64_raw'] = jax_step(raw)
    out['port32'] = _port_step(variables, batch, torch.float32)
    out['port64'] = _port_step(variables, batch, torch.float64)
    out['port64_raw'] = _port_step(raw, batch, torch.float64)
    out['old_stats'] = _torch(variables['batch_stats'], 'batch_stats')
    return out


def _leaf_errors(got, want, floor):
    """{leaf: max|got - want| / max(max|want|, floor * largest leaf)}."""
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), floor * top)
            for k, w in want.items()}


def test_loss(step):
    """The loss and its parts: the port's f32 within 1e-5 and its f64
    within 1e-6 of JAX's f64 (whose LSS one-hot products run in f32 on
    the CPU)."""
    want = step['jax64'][1]
    want['loss'] = step['jax64'][0]
    for run, tol in (('port32', 1e-5), ('port64', 1e-6)):
        got = dict(step[run][1], loss=step[run][0])
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= tol * abs(v) + 1e-9, (run, k)
    assert want['num_pos'] >= 2 and want['loss_depth'] > 0


def test_every_gradient_leaf(step):
    """f64 in both packages: the same gradient function."""
    want, got = step['jax64'][3], step['port64'][3]
    assert set(want) == set(got)
    err = _leaf_errors(got, want, 1e-9)
    bad = {k: v for k, v in err.items() if v > 1e-5}
    assert not bad, bad
    # The LSS view transform's backward reached DepthNet's depth head.
    assert float(got['lss.depthnet.depth_conv.weight'].abs().max()) > 0


def test_every_gradient_leaf_on_unconditioned_weights(step):
    """f64 in both packages on the mini variables as drawn, where the ReLU
    masks clip (on the conditioned weights almost nothing does): the loss
    within 1e-6 and every gradient leaf within 1e-5 of its max|ref|."""
    assert step['port64_raw'][4] > 0.3 and step['port64'][4] < 1e-2, (
        step['port64_raw'][4], step['port64'][4])
    want, got = step['jax64_raw'], step['port64_raw']
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    assert set(want[3]) == set(got[3])
    err = _leaf_errors(got[3], want[3], 1e-9)
    bad = {k: v for k, v in err.items() if v > 1e-5}
    assert not bad, bad


def test_f32_gradients(step):
    """The port's f32 gradients within 1e-2 of the f64 ones in every leaf,
    and no further off at their worst than flax's own f32 gradients."""
    want = step['jax64'][3]
    port = _leaf_errors(step['port32'][3], want, 1e-6)
    flax = _leaf_errors(step['jax32'][3], want, 1e-6)
    bad = {k: v for k, v in port.items() if v > 1e-2}
    assert not bad, bad
    assert max(port.values()) <= max(flax.values()), (max(port.values()),
                                                       max(flax.values()))


def test_new_batch_stats(step):
    """The port's f32 running statistics within 1e-4 of max|ref| of JAX's
    f64 ones; the frozen backbone's unchanged, every other one moved."""
    want, got, old = step['jax64'][2], step['port32'][2], step['old_stats']
    assert set(want) == set(got)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (k, err)
        if k.startswith('resnet.'):              # frozen backbone BN
            assert torch.equal(got[k], old[k]), k
        else:
            assert not torch.equal(got[k], old[k]), k


def test_bf16_policy_casts_what_jax_casts():
    batch = train_batch()
    jax_cast = jax_amp._to_bf16(batch)
    port_cast = amp.to_bf16({k: torch.from_numpy(v) for k, v in
                             batch.items()})
    for k, v in jax_cast.items():
        assert (port_cast[k].dtype == torch.bfloat16) == (
            v.dtype == jnp.bfloat16), k
    params = flax_to_torch(mini_variables(), PORT_TRAIN_CFG,
                           collections=('params',))
    assert all(v.dtype == torch.bfloat16 for v in amp.to_bf16(params).values())
    seen = {}

    def loss_fn(model, params, batch):
        seen.update(params=params, batch=batch)
        return sum(p.float().sum() for p in params.values()), {
            'x': torch.ones((), dtype=torch.bfloat16)}

    loss, aux = amp.bf16_policy(loss_fn)(None, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == aux['x'].dtype == torch.float32
    assert seen['batch']['gt_labels'].dtype == torch.int32
    assert seen['batch']['imgs'].dtype == torch.bfloat16


@pytest.mark.parametrize('policy', ['cosine', 'step'])
def test_lr_schedule_matches_optax(policy):
    kw = dict(base_lr=2e-4, total_steps=1000, policy=policy, warmup_iters=50,
              step_epochs=(3, 5), steps_per_epoch=100)
    want = jax_make_lr_schedule(**kw)
    got = make_lr_schedule(**kw)
    for count in (0, 1, 25, 49, 50, 51, 249, 250, 300, 449, 450, 999, 1000,
                  1500):
        w = float(want(count))      # optax in f32: 1e-6 of the base rate
        assert abs(got(count) - w) <= 1e-6 * kw['base_lr'], (count, w)


def test_optimizer_matches_optax_over_three_steps():
    """Identical gradients into optax's chain(clip_by_global_norm(35),
    adamw) and the port's: parameters within 1e-6 of max|p| after each of
    3 steps; the first step's gradients are clipped, the others not."""
    rng = np.random.RandomState(2)
    shapes = [(64, 13), (64,), (3, 3, 8, 16), (9,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in (40.0, 0.5, 2.0)]
    schedule = jax_make_lr_schedule(1e-2, 10, warmup_iters=2)
    tx = jax_make_optimizer(schedule)
    state, p = tx.init(params), params

    t_params = [torch.from_numpy(x.copy()) for x in params]
    opt = make_optimizer(t_params, make_lr_schedule(1e-2, 10,
                                                    warmup_iters=2))
    for g in grads:
        norm = float(optax.global_norm(g))
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        got_norm = opt.step([torch.from_numpy(x) for x in g])
        assert abs(float(got_norm) - norm) <= 1e-6 * norm
        for a, b in zip(t_params, p):
            b = np.asarray(b)
            assert float(np.abs(a.numpy() - b).max()) <= 1e-6 * float(
                np.abs(b).max())
    assert opt.count == 3


def _tiny_state(seed=0):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    torch.manual_seed(seed)
    return create_train_state(model, functools.partial(
        make_optimizer, lr_schedule=make_lr_schedule(1e-2, 20,
                                                     warmup_iters=2)))


def _tiny_loss(model, params, batch):
    out = torch.func.functional_call(model, dict(params), (batch['x'],))
    loss = (out - batch['y']).pow(2).mean()
    return loss, {'mse': loss}


def test_checkpoint_round_trip_and_rotation(tmp_path):
    state = _tiny_state()
    step = make_train_step(_tiny_loss)
    rng = np.random.RandomState(0)
    for i in range(5):
        batch = {'x': rng.randn(8, 4).astype(np.float32),
                 'y': rng.randn(8, 3).astype(np.float32)}
        state, loss, aux = step(state, batch)
        save_checkpoint(str(tmp_path), state, i + 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'ckpt_3.pt', 'ckpt_4.pt', 'ckpt_5.pt']
    fresh = load_checkpoint(str(tmp_path), _tiny_state(seed=1))
    assert fresh.step == state.step == 5 and fresh.optimizer.count == 5
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    fresh.optimizer.mu + fresh.optimizer.nu):
        assert torch.equal(a, b)
    older = load_checkpoint(str(tmp_path / 'ckpt_3.pt'), _tiny_state(1))
    assert older.step == 3


def test_run_training_guards_and_logs(tmp_path):
    """The finite-loss guard reads the loss at the log interval and at
    the end of the epoch only; a NaN there raises before a checkpoint."""
    state = _tiny_state()
    rng = np.random.RandomState(1)
    batches = [{'x': rng.randn(8, 4).astype(np.float32),
                'y': rng.randn(8, 3).astype(np.float32)} for _ in range(5)]
    logger = JsonLogger(str(tmp_path), 'train')
    state = run_training(state, make_train_step(_tiny_loss), batches, 2,
                         logger=logger, log_interval=2,
                         ckpt_dir=str(tmp_path / 'ckpt'))
    assert state.step == 10
    lines = (tmp_path / 'train.log.json').read_text().splitlines()
    assert len(lines) == 6                        # iters 0, 2, 4 per epoch
    batches[-1]['y'][0, 0] = np.nan
    with pytest.raises(FloatingPointError, match='end of epoch 0'):
        run_training(_tiny_state(), make_train_step(_tiny_loss), batches, 1,
                     log_interval=100, ckpt_dir=str(tmp_path / 'nan'))
    assert not (tmp_path / 'nan').exists()


def test_other_families_are_not_ported():
    """Every family of the builder trains since BEVFormer-T's training
    slice (its loss needs no anchors); a model_type the builder does not
    know is refused."""
    assert callable(make_loss_fn_generic(None, 'bevformer', None))
    with pytest.raises(ValueError, match='unknown model_type'):
        make_loss_fn_generic(None, 'centerpoint', np.zeros((1, 1, 1, 9)))
