"""BEVFormer-T's train step on the port against the JAX package, on the
CPU, at the tiny configuration of ``tests/test_parallel.py``'s BEVFormer
data-parallel test (BEV 8x12, 16 queries, 32 dims, 1 + 2 layers, 2
cameras of the ring rig, queue 2, ResNet-18, 32x48 images), batch 2 with
5 valid and 3 padded GTs per sample:

* one step's loss and the last layer's ``loss_cls`` / ``loss_bbox``
  within 1e-5 of JAX's, the matches of every decoder layer equal, with
  the SCA masked dense (``sca_query_cap`` 1.0) and capped (0.5), with the
  history frame used (``has_prev``) and not;
* every f32 gradient leaf, JAX's carried to the port's names by the
  weight bridge (it is linear, so it carries gradients too), within
  ``GRAD_TOL`` of the leaf's max|ref| (measured below);
* the port's f64 gradient against central differences on seeded
  directions over all parameters (JAX's ``bilinear_sample`` cannot run
  under x64, ROADMAP queue 3 item 10), with no history frame in use so
  that the loss is the function the gradient differentiates (the history
  BEV is computed without gradients);
* one and three clip + AdamW steps of ``make_train_step`` against JAX's
  ``make_train_step``: each parameter within ``ADAM_LRS`` learning rates
  (Adam moves a parameter by about one learning rate per step whatever
  its gradient's size, so an f32 rounding of a near-zero gradient moves
  it by as much);
* one bf16-policy step against JAX's bf16 step, the gap pinned.

JAX's deformable attention is forced onto its gather path
(``ONEHOT_MAX_TABLE`` = 0): at these tables ``impl='auto'`` would take the
one-hot dual, and the port is held to the gather path.  The variables are
the port's seeded initialisation carried to flax and perturbed
(``tests/test_torch_port_bevformer.py:bridged_variables``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import omnihd_scenes_tpu.ops.ms_deform_attn as jax_msda
from omnihd_scenes_tpu.models.bevformer.detector import (
    BEVFormerConfig as JaxCfg, BEVFormerDetector as JaxDetector)
from omnihd_scenes_tpu.models.hungarian import (
    hungarian_match as jax_hungarian_match)
from omnihd_scenes_tpu.models.bbox_coder import (
    normalize_bbox as jax_normalize_bbox)
from omnihd_scenes_tpu.train import amp as jax_amp
from omnihd_scenes_tpu.train.builder import (
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu.train.loop import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step)
from omnihd_scenes_tpu.train.optim import (
    make_lr_schedule as jax_make_lr_schedule,
    make_optimizer as jax_make_optimizer)
from omnihd_scenes_tpu_torch.config import BEVFormerConfig
from omnihd_scenes_tpu_torch.models.bbox_coder import normalize_bbox
from omnihd_scenes_tpu_torch.models.bevformer import (BEVFormerDetector,
                                                      bevformer_head_loss)
from omnihd_scenes_tpu_torch.models.hungarian import hungarian_match
from omnihd_scenes_tpu_torch.train import amp
from omnihd_scenes_tpu_torch.train.builder import (anchors_for, forward,
                                                   make_loss_fn_generic)
from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                make_train_step)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_lidar2img
from omnihd_scenes_tpu_torch.weights import (flax_to_torch,
                                             flax_tree_to_torch,
                                             load_state_dict)
from tests.test_torch_port_bevformer import bridged_variables

torch.set_num_threads(1)

TINY = dict(bev_h=8, bev_w=12, num_query=16, embed_dims=32,
            encoder_layers=1, decoder_layers=2, num_cams=2, queue_length=2,
            pc_range=(-8, -8, -3.0, 8, 8, 5.0), resnet_depth=18,
            resnet_out_indices=(3,), img_hw=(32, 48))
CAPS = (1.0, 0.5)
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5          # measured 4.0e-6 to 5.9e-6 over the four cases
FD_TOL = 1e-6            # measured 1.7e-9 to 4.4e-9
ADAM_LRS = 2.5           # measured 2.0 (a key bias, whose gradient is 0)
ADAM_MOVED = 1e-4        # share of parameters off by > 0.1 lr: 1.1e-5
LR = 1e-3
BF16_LOSS_TO_JAX = 3e-3  # measured 1.1e-3
BF16_GRAD_TO_JAX = 0.15  # relative L2, measured 6.9e-2


def configs(cap):
    return (BEVFormerConfig(**TINY, sca_query_cap=cap),
            JaxCfg(**TINY, sca_query_cap=cap))


@pytest.fixture(scope='module', autouse=True)
def jax_gather_path():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_msda, 'ONEHOT_MAX_TABLE', 0)
        yield


def make_batch(has_prev, seed=0, b=2, n_gt=8, n_valid=5):
    rng = np.random.RandomState(seed)
    q, n, (h, w) = TINY['queue_length'], TINY['num_cams'], TINY['img_hw']
    can_bus = np.zeros((b, q, 18), np.float32)
    can_bus[:, :, -2] = rng.uniform(0, 2 * np.pi, (b, q))
    can_bus[:, 1:, :2] = rng.uniform(-1.0, 1.0, (b, q - 1, 2))
    can_bus[:, 1:, -1] = rng.uniform(-3, 3, (b, q - 1))
    boxes = np.zeros((b, n_gt, 9), np.float32)
    boxes[:, :n_valid, :2] = rng.uniform(-6, 6, (b, n_valid, 2))
    boxes[:, :n_valid, 2] = rng.uniform(-2, 1, (b, n_valid))
    boxes[:, :n_valid, 3:6] = rng.uniform(0.5, 3, (b, n_valid, 3))
    boxes[:, :n_valid, 6:] = rng.uniform(-2, 2, (b, n_valid, 3))
    mask = np.zeros((b, n_gt), bool)
    mask[:, :n_valid] = True
    return {
        'imgs': rng.randn(b, q, n, h, w, 3).astype(np.float32),
        'can_bus': can_bus,
        'lidar2img': np.tile(ring_rig_lidar2img(img_hw=(h, w))[:n],
                             (b, q, 1, 1, 1)).astype(np.float32),
        'has_prev': np.array([[False, has_prev]] * b),
        'gt_boxes': boxes,
        'gt_labels': rng.randint(0, 4, (b, n_gt)).astype(np.int32),
        'gt_mask': mask}


def torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def variables():
    return bridged_variables(configs(1.0)[0], seed=5)


def port_model(variables, cap, dtype=torch.float32):
    cfg = configs(cap)[0]
    model = BEVFormerDetector(cfg)
    load_state_dict(model, flax_to_torch(variables, cfg))
    return model.to(dtype).train()


_JAX = {}


def jax_fns(cap):
    """JAX's jitted loss-and-gradient and its per-sample queue forward for
    one SCA cap (a static field of the flax modules)."""
    if cap not in _JAX:
        jm = JaxDetector(configs(cap)[1])
        loss_fn = jax_make_loss_fn(jm, 'bevformer')
        _JAX[cap] = dict(
            jm=jm, loss_fn=loss_fn,
            grad=jax.jit(jax.value_and_grad(loss_fn, has_aux=True)),
            forward=jax.jit(jax.vmap(lambda v, s: jm.apply(
                v, s['imgs'], s['can_bus'], s['lidar2img'], s['has_prev'],
                train=True), in_axes=(None, 0))))
    return _JAX[cap]


def jax_matches(cap, variables, batch):
    """(B, L, G) matches of JAX's outputs, by JAX's scipy matcher."""
    out = jax_fns(cap)['forward'](variables, {
        k: batch[k] for k in ('imgs', 'can_bus', 'lidar2img', 'has_prev')})
    cls, box = np.asarray(out['all_cls_scores']), np.asarray(
        out['all_bbox_preds'])
    return np.stack([np.stack([np.asarray(jax_hungarian_match(
        cls[i, lvl], box[i, lvl], jax_normalize_bbox(batch['gt_boxes'][i]),
        batch['gt_labels'][i], batch['gt_mask'][i], solver='scipy')[0])
        for lvl in range(cls.shape[1])]) for i in range(cls.shape[0])])


def port_step(model, batch, loss_fn=None):
    """(loss, aux, {name: grad}) of one port step without the optimizer."""
    loss_fn = loss_fn or make_loss_fn_generic(model, 'bevformer', None)
    params = dict(model.named_parameters())
    loss, aux = loss_fn(model, params, batch)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


CASES = [(cap, hp) for cap in CAPS for hp in (True, False)]


@pytest.fixture(scope='module')
def steps(variables):
    out = {}
    for cap, hp in CASES:
        batch = make_batch(hp, seed=int(cap * 10) + hp)
        f = jax_fns(cap)
        (loss, (aux, _)), grads = f['grad'](
            variables['params'], variables['batch_stats'], batch)
        model = port_model(variables, cap)
        p_loss, p_aux, p_grads = port_step(model, torch_batch(batch))
        outs = forward(model, None, torch_batch(batch), 'bevformer')
        tb = torch_batch(batch)
        l = outs['all_cls_scores'].shape[1]

        def per_layer(x):
            return x[:, None].expand(x.shape[0], l, *x.shape[1:])

        matched, _ = hungarian_match(
            outs['all_cls_scores'], outs['all_bbox_preds'],
            per_layer(normalize_bbox(tb['gt_boxes'])),
            per_layer(tb['gt_labels']), per_layer(tb['gt_mask']))
        out[cap, hp] = dict(
            batch=batch, jax=(float(loss), {k: float(v) for k, v in
                                            aux.items()},
                              flax_tree_to_torch(grads, configs(cap)[0])),
            port=(float(p_loss), {k: float(v) for k, v in p_aux.items()},
                  p_grads),
            matches=(matched.numpy(), jax_matches(cap, variables, batch)))
    return out


@pytest.mark.parametrize('cap,has_prev', CASES)
def test_loss_and_matches_equal_jax(steps, cap, has_prev):
    s = steps[cap, has_prev]
    (loss, aux, _), (want, want_aux, _) = s['port'], s['jax']
    assert abs(loss - want) <= LOSS_TOL * abs(want), (loss, want)
    assert set(aux) == set(want_aux) == {'loss_cls', 'loss_bbox'}
    for k, v in want_aux.items():
        assert abs(aux[k] - v) <= LOSS_TOL * max(abs(v), 1.0), (k, aux[k], v)
    got, want_m = s['matches']
    np.testing.assert_array_equal(got, want_m)
    assert (got[:, :, :5] >= 0).all() and (got[:, :, 5:] == -1).all()


@pytest.mark.parametrize('cap,has_prev', CASES)
def test_f32_gradients_equal_jax(steps, cap, has_prev):
    """Every leaf within GRAD_TOL of its max|ref|, but the decoder
    self-attention's key biases: a bias added to every key moves each
    query's logits by one constant, which the softmax removes, so their
    gradient is 0 in exact arithmetic and both sides hold rounding noise
    (measured 1e-8 against a largest leaf of 45): held within 1e-6 of the
    gradient's largest element instead."""
    grads, want = steps[cap, has_prev]['port'][2], steps[cap, has_prev][
        'jax'][2]
    assert set(grads) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        err = float((grads[k] - w).abs().max())
        if k.endswith('self_attn.key.bias'):
            assert err <= 1e-6 * top, (k, err)
        else:
            worst = max(worst, err / float(w.abs().max()))
    assert worst <= GRAD_TOL, worst


@pytest.mark.parametrize('cap', CAPS)
def test_f64_gradient_against_central_differences(cap):
    """One decoder layer and no history in use: the decoder's refined
    references are detached between layers and the history BEV is
    computed without gradients (as in JAX and upstream), so with more
    layers or the history the gradient is not the derivative of the loss
    by design.  The step is 1e-8: the loss is piecewise smooth (ReLU
    kinks, and bilinear sampling, linear between pixel centres), and
    steps of 1e-6 to 1e-5 along all parameters at once cross enough kinks
    to move the quotient by 1e-4 to 1e-2; at 1e-8 it agrees within 5e-9
    (measured), far above f64's rounding."""
    cfg = dataclasses.replace(configs(cap)[0], decoder_layers=1)
    batch = torch_batch(make_batch(False, seed=40), torch.float64)
    model = BEVFormerDetector(cfg)
    load_state_dict(model, flax_to_torch(bridged_variables(cfg, seed=6),
                                         cfg))
    model = model.double().train()
    loss_fn = make_loss_fn_generic(model, 'bevformer', None)
    _, _, grads = port_step(model, batch, loss_fn)
    params = dict(model.named_parameters())
    rng = np.random.RandomState(41)
    eps = 1e-8
    for _ in range(3):
        dirs = {k: torch.from_numpy(rng.randn(*p.shape)) for k, p in
                params.items()}

        def loss_at(sign):
            moved = {k: p.detach() + sign * eps * dirs[k]
                     for k, p in params.items()}
            with torch.no_grad():
                return float(loss_fn(model, moved, batch)[0])

        fd = (loss_at(1.0) - loss_at(-1.0)) / (2 * eps)
        an = float(sum((grads[k] * d).sum() for k, d in dirs.items()))
        assert abs(fd - an) <= FD_TOL * max(abs(an), 1.0), (fd, an)


def test_adamw_steps_equal_jax(variables):
    """Three steps of the port's ``make_train_step`` against JAX's, one
    fresh batch each (the history used), lr 1e-3 after a 2-step warmup."""
    cap = 1.0
    batches = [make_batch(True, seed=50 + i) for i in range(3)]
    tx = jax_make_optimizer(jax_make_lr_schedule(LR, 10, warmup_iters=2))
    jstate = jax_create_train_state(variables, tx)
    jstep = jax_make_train_step(jax_fns(cap)['loss_fn'], tx)
    model = port_model(variables, cap)
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(LR, 10, warmup_iters=2)))
    step = make_train_step(make_loss_fn_generic(model, 'bevformer', None))
    lrs = 0.0
    for i, batch in enumerate(batches):
        lrs += make_lr_schedule(LR, 10, warmup_iters=2)(i)
        jstate, jloss, _ = jstep(jstate, batch)
        state, loss, _ = step(state, torch_batch(batch))
        assert abs(float(loss) - float(jloss)) <= 2e-5 * abs(float(jloss))
        if i in (0, 2):
            want = flax_tree_to_torch(jstate.params, configs(cap)[0])
            got = dict(model.named_parameters())
            diff = torch.cat([(got[k].detach() - w).abs().flatten()
                              for k, w in want.items()])
            assert float(diff.max()) <= ADAM_LRS * lrs, (i, diff.max(), lrs)
            moved = float((diff > 0.1 * lrs).double().mean())
            assert moved <= ADAM_MOVED, (i, moved)
    assert state.step == 3 and int(jstate.step) == 3


def _rel_l2(got, want):
    return (sum(float((got[k] - w).square().sum()) for k, w in want.items())
            / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def test_bf16_step_against_jax(variables):
    """One step under the bf16 policy: the port's loss reads the outputs
    in f32 (the GT boxes arrive in bf16 and are upcast), JAX's in bf16.
    Measured: loss 1.1e-3 and gradient 6.9e-2 (relative L2) from JAX's
    bf16 step; the port's bf16 gradient 6.3e-2 and JAX's own 6.5e-2 from
    JAX's f32 gradient: the gap is bf16's rounding of the forward."""
    cap, batch = 1.0, make_batch(True, seed=60)
    f = jax_fns(cap)
    (want, _), want_grads = jax.jit(jax.value_and_grad(
        jax_amp.bf16_policy(f['loss_fn']), has_aux=True))(
            variables['params'], variables['batch_stats'], batch)
    want_grads = flax_tree_to_torch(want_grads, configs(cap)[0])
    f32_grads = flax_tree_to_torch(f['grad'](
        variables['params'], variables['batch_stats'], batch)[1],
        configs(cap)[0])
    model = port_model(variables, cap)
    loss, _, grads = port_step(model, torch_batch(batch), amp.bf16_policy(
        make_loss_fn_generic(model, 'bevformer', None)))
    want = float(want)
    gap = abs(float(loss) - want) / abs(want)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert gap <= BF16_LOSS_TO_JAX, gap
    assert _rel_l2(grads, want_grads) <= BF16_GRAD_TO_JAX
    assert _rel_l2(grads, f32_grads) <= 2 * _rel_l2(want_grads, f32_grads)


def test_training_after_serving_in_one_process(variables):
    """A served frame (inference mode) first makes the per-device
    constants of the deformable attention and the encoder; a train step
    after it must be able to save them for its backward."""
    from omnihd_scenes_tpu_torch.models.bevformer import attention
    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor

    attention._normalizer.cache_clear()
    cfg = configs(1.0)[0]
    predictor = StreamPredictor(cfg, port_model(variables, 1.0).state_dict(),
                                device='cpu', dtype=torch.float32)
    batch = make_batch(True, seed=70)
    predictor(*(torch.from_numpy(batch[k][:, -1]) for k in (
        'imgs', 'can_bus', 'lidar2img')), predictor.zero_bev(2),
        torch.from_numpy(batch['has_prev'][:, -1]))
    model = predictor.model.train()
    loss, _, grads = port_step(model, torch_batch(batch))
    assert np.isfinite(float(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())


def test_history_is_detached_and_backbone_stays_frozen(variables):
    """The queue forward's gradient is the gradient of the last frame fed
    the history BEV as a constant (history under ``no_grad``, the BEV
    rotation acting on the detached BEV), and a train-mode step leaves
    the frozen backbone's BatchNorm statistics as they were."""
    model = port_model(variables, 1.0)
    batch = torch_batch(make_batch(True, seed=80))
    stats = {k: v.clone() for k, v in model.img_backbone.state_dict().items()
             if 'running' in k}
    _, _, grads = port_step(model, batch)
    for k, v in model.img_backbone.state_dict().items():
        if 'running' in k:
            assert torch.equal(v, stats[k]), k
    head = model.pts_bbox_head
    with torch.no_grad():
        prev = head.get_bev(model.extract_img_feat(batch['imgs'][:, 0]),
                            batch['can_bus'][:, 0], batch['lidar2img'][:, 0],
                            TINY['img_hw'], prev_bev=torch.zeros(
                                2, 96, 32), has_prev=batch['has_prev'][:, 0])

    out = model.forward_stream(batch['imgs'][:, -1], batch['can_bus'][:, -1],
                               batch['lidar2img'][:, -1], prev,
                               batch['has_prev'][:, -1])
    loss = bevformer_head_loss(out['all_cls_scores'], out['all_bbox_preds'],
                               batch['gt_boxes'], batch['gt_labels'],
                               batch['gt_mask'])['total'].mean()
    loss.backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[k], rtol=1e-5, atol=1e-7)


def test_chunked_deformable_attention_gradient():
    """The deformable attention's query chunks (one ``F.grid_sample`` per
    chunk) give the unchunked value and gradient, in f32 and for bf16
    values sampled in f32."""
    from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
        multi_scale_deformable_attn)

    rng = np.random.RandomState(90)
    shapes = ((6, 8), (3, 4))
    for dtype in (torch.float32, torch.bfloat16):
        value = torch.from_numpy(rng.randn(2, 60, 4, 8).astype(
            np.float32)).to(dtype).requires_grad_()
        loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 50, 4, 2, 3, 2))
                               .astype(np.float32)).requires_grad_()
        wgt = torch.from_numpy(rng.uniform(0, 1, (2, 50, 4, 2, 3)).astype(
            np.float32)).to(dtype).requires_grad_()
        cot = torch.from_numpy(rng.randn(2, 50, 32).astype(np.float32))
        runs = []
        for chunk in (None, 7):
            out = multi_scale_deformable_attn(value, shapes, loc, wgt,
                                              query_chunk=chunk)
            grads = torch.autograd.grad((out.float() * cot).sum(),
                                        (value, loc, wgt))
            runs.append((out, grads))
        (a, ga), (b, gb) = runs
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        for x, y in zip(ga, gb):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_anchors_for_the_detr_head_is_none():
    assert anchors_for(BEVFormerDetector(configs(1.0)[0]), 'bevformer') is None
