"""Rank processes of the data-parallel tests: JAX-free, so each spawned
rank starts without importing JAX (spawn pickles the target by module
path).

:func:`run_ranks` starts W ranks over gloo on the CPU (a file rendezvous
in the caller's directory, so parallel test workers never collide), each
running :func:`rank_main`: every scenario of ``spec`` in order, in one
process group, its results saved to ``<dir>/rank<r>.pt``.  A rank that
does not finish within the timeout is killed and the call fails.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def run_ranks(spec: dict, directory: str, world: int = 2,
              timeout: float = 600.0) -> list:
    """Run ``spec``'s scenarios on ``world`` ranks; each rank's results."""
    import torch.multiprocessing as mp

    spec_path = os.path.join(directory, 'spec.pt')
    torch.save(spec, spec_path)
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=rank_main, args=(r, world, directory))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f'ranks {hung} did not finish in {timeout} s')
    out = [torch.load(os.path.join(directory, f'rank{r}.pt'),
                      weights_only=False) for r in range(world)]
    errors = [o['error'] for o in out if 'error' in o]
    if errors:
        raise RuntimeError('a rank failed:\n' + '\n'.join(errors))
    return out


def rank_main(rank: int, world: int, directory: str) -> None:
    from omnihd_scenes_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    results = {}
    try:
        distributed.init_distributed(
            'cpu', init_method=f'file://{os.path.join(directory, "rdzv")}',
            rank=rank, world_size=world)
        spec = torch.load(os.path.join(directory, 'spec.pt'),
                          weights_only=False)
        for name, args in spec.items():
            results[name] = SCENARIOS[name.split(':')[0]](rank, world,
                                                          **args)
    except BaseException:
        results['error'] = f'rank {rank}: {traceback.format_exc()}'
    finally:
        distributed.destroy_distributed()
        torch.save(results, os.path.join(directory, f'rank{rank}.pt'))


def f64_batch(batch: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def train_step_record(model, loss_fn, batch, lr: float = 1e-3):
    """One ``make_train_step`` step with AdamW: (loss and aux as the
    ranks' means, the gradients the optimizer received, the model's state
    after the step)."""
    from omnihd_scenes_tpu_torch.parallel.mesh import reduce_scalars
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(lr, 100, warmup_iters=0)))
    seen = {}
    step = state.optimizer.step

    def record(grads):
        seen['grads'] = {k: g.detach().clone() for k, g in
                         zip(dict(model.named_parameters()), grads)}
        return step(grads)

    state.optimizer.step = record
    _, loss, aux = make_train_step(loss_fn)(state, batch)
    scalars = {k: float(v) for k, v in
               reduce_scalars({'loss': loss, **aux}).items()}
    return {'scalars': scalars, 'grads': seen['grads'],
            'state': {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def leaf_errors(got, want, floor=0.0):
    """{leaf: max|got - want| / max(max|want|, floor * largest leaf)};
    integer leaves: 1.0 where they differ."""
    top = max(float(w.abs().max()) for w in want.values()
              if w.is_floating_point())
    return {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), floor * top, 1e-300)
            if w.is_floating_point() else float((got[k] != w).any())
            for k, w in want.items()}


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode() + v.reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


@scenario
def bevfusion_step(rank, world, cfg, state_dict, batch, anchors,
                   depth_range, lr):
    """The mini BEVFusion's f64 step on this rank's rows, then, from the
    same weights, the control: the gradient with the BatchNorm and
    depth-loss reductions turned off, averaged over the ranks.  Rank 0
    then takes the one-process step on the whole batch (no group
    registered) and returns both steps' scalars and the errors of the
    data-parallel step and of the control against it; every rank returns
    a digest of its state after the step."""
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.parallel import mesh
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic

    model = BEVFusion(cfg).double()
    model.load_state_dict(state_dict)
    loss_fn = make_loss_fn_generic(model, 'bevfusion', anchors,
                                   camera_depth_range=depth_range)
    batch = f64_batch(batch)
    part = mesh.shard_batch(batch)
    dp = train_step_record(model, loss_fn, part, lr)

    model.load_state_dict(state_dict)
    sync_group, mesh.sync_group = mesh.sync_group, lambda: None
    try:
        loss, _ = loss_fn(model, None, {k: torch.from_numpy(v)
                                        for k, v in part.items()})
        loss.backward()
    finally:
        mesh.sync_group = sync_group
    control = [p.grad for p in model.parameters()]
    mesh.all_reduce_gradients(control)
    control = dict(zip(dict(model.named_parameters()), control))
    out = {'digest': state_digest(dp['state'])}
    if rank != 0:
        return out

    model.load_state_dict(state_dict)
    group = mesh.data_parallel_group()
    mesh.set_data_parallel_group(None)
    try:
        one = train_step_record(model, loss_fn, batch, lr)
    finally:
        mesh.set_data_parallel_group(group)
    params = dict(model.named_parameters())
    stats = [k for k in one['state'] if 'running' in k]
    return dict(
        out, scalars=dp['scalars'], one_scalars=one['scalars'],
        grad_errors=leaf_errors(dp['grads'], one['grads'], 1e-6),
        stat_errors=leaf_errors({k: dp['state'][k] for k in stats},
                                {k: one['state'][k] for k in stats}),
        param_lr=max(float((dp['state'][k] - one['state'][k]).abs().max())
                     for k in params) / lr,
        control_errors=leaf_errors(control, one['grads'], 1e-6),
        depth_conv_grad=float(one['grads'][
            'lss.depthnet.depth_conv.weight'].abs().max()))


@scenario
def pillars_step(rank, world, cfg, dims, state_dict, batch, anchors):
    """A PointPillars f64 step on this rank's rows: the ranks' mean loss,
    the reduced gradients (rank 0) and a digest of the state after it."""
    from omnihd_scenes_tpu_torch.models.detectors import PointPillars
    from omnihd_scenes_tpu_torch.parallel import mesh
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic

    model = PointPillars(cfg, dims).double()
    model.load_state_dict(state_dict)
    loss_fn = make_loss_fn_generic(model, 'pointpillars', anchors)
    out = train_step_record(model, loss_fn,
                            mesh.shard_batch(f64_batch(batch)))
    return {'loss': out['scalars']['loss'], 'digest': state_digest(
        out['state']), **({'grads': out['grads']} if rank == 0 else {})}


@scenario
def batch_norm(rank, world, x, weight, bias, cotangent, eps):
    """A train-mode ``BatchNorm`` on this rank's rows of ``x``: its output
    rows, this rank's gradients of its rows' <y, cotangent> (their sum over
    the ranks is the gradient of the whole batch's), its new running
    statistics."""
    from omnihd_scenes_tpu_torch.models.layers import BatchNorm
    from omnihd_scenes_tpu_torch.parallel import mesh

    bn = BatchNorm(x.shape[1], eps).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    part = mesh.shard_batch({'x': x, 'c': cotangent})
    xr = torch.from_numpy(part['x']).requires_grad_()
    y = bn(xr)
    (y * torch.from_numpy(part['c'])).sum().backward()
    return {'y': y.detach(), 'dx': xr.grad, 'dweight': bn.weight.grad,
            'dbias': bn.bias.grad, 'mean': bn.running_mean.clone(),
            'var': bn.running_var.clone()}


@scenario
def depth_loss(rank, world, pred, gt, d_min, depth_range):
    """``depth_dist_loss`` on this rank's rows: the ranks' mean loss and
    this rank's gradient of its term (times W: the rows' share of the
    gradient of the mean)."""
    from omnihd_scenes_tpu_torch.models.bevfusion import depth_dist_loss
    from omnihd_scenes_tpu_torch.parallel import mesh

    part = mesh.shard_batch({'p': pred, 'g': gt, 'd': d_min})
    p = torch.from_numpy(part['p']).requires_grad_()
    loss = depth_dist_loss(p, torch.from_numpy(part['g']),
                           torch.from_numpy(part['d']), depth_range)
    loss.backward()
    return {'loss': float(mesh.reduce_scalars({'l': loss})['l']),
            'dpred': p.grad / world}


@scenario
def collect(rank, world, counts, total_size=None):
    """``collect_results`` of ``counts[rank]`` results (or its error)."""
    from omnihd_scenes_tpu_torch.parallel.distributed import collect_results

    local = [{'token': np.array([rank * 100 + i]),
              'boxes': np.full((4, 9), rank * 100 + i, np.float32),
              'valid': np.arange(3) < i}
             for i in range(counts[rank])]
    try:
        return {'out': collect_results(local, total_size=total_size)}
    except RuntimeError as e:
        return {'error': str(e)}


@scenario
def card_step(rank, world, cfg, state_dict, batch, lr):
    """A small BEVFusion f32 step on ``cuda:0`` (TF32 off) on this rank's
    rows, over the group's gloo: the ranks' mean loss, the LSS forward
    and backward launches, the state after the step (on the host) and its
    digest, the reduced gradients."""
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.parallel import mesh
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = BEVFusion(cfg)
    model.load_state_dict(state_dict)
    model.to('cuda:0')
    mesh.broadcast_state(model)
    loss_fn = make_loss_fn_generic(model, 'bevfusion', cfg.pillars.anchors(),
                                   camera_depth_range=cfg.lss.camera_depth_range)
    before = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    out = train_step_record(model, loss_fn, mesh.shard_batch(batch), lr)
    launches = (lss_sample_bev.launches - before[0],
                lss_sample_bev_backward.launches - before[1])
    state = {k: v.cpu() for k, v in out['state'].items()}
    return {'loss': out['scalars']['loss'], 'launches': launches,
            'digest': state_digest(state), 'state': state,
            'grads': {k: g.cpu() for k, g in out['grads'].items()}}
