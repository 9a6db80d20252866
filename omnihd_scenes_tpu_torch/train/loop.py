"""Training runtime (counterpart of ``omnihd_scenes_tpu/train/loop.py``):
train state, the train step, checkpoints, the epoch loop.

The reference's ``custom_train_detector`` (``apis/mmdet_train.py``) runs
dataloaders, the optimizer and lr/ckpt/log hooks; the JAX package jits one
``train_step`` and writes orbax checkpoints.  Here the step runs eagerly:
forward, loss, ``backward``, then the optimizer's clip + AdamW, with
BatchNorm's running statistics updated in the model's buffers.
Checkpoints are ``torch.save`` files, ``ckpt_<step>.pt``, the last
``max_keep`` kept.  The loop takes batches through ``data/prefetch.py``
(a background thread; on a CUDA device also the pinned upload on a side
stream) and reads the loss and the step's other scalars back from the
device in one copy, only at the log interval and at the end of an epoch
that did not end on a logged step (the reference's ``GradChecker`` becomes
that finite-loss guard), so the host never waits for the device inside a
step.

Data parallel (``parallel/``, one rank a process under ``torchrun``): each
rank steps on its rows of the global batch, the gradients are averaged
over the ranks before the clip, the logged scalars are the ranks' means,
and rank 0 alone writes checkpoints.  With one rank every step and every
file is as before.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from omnihd_scenes_tpu_torch.parallel import distributed
from omnihd_scenes_tpu_torch.parallel import mesh as dp
from omnihd_scenes_tpu_torch.train.optim import AdamW
from omnihd_scenes_tpu_torch.utils.timing import span


@dataclass
class TrainState:
    """The model (f32 parameters and BatchNorm statistics), its optimizer
    and the number of steps taken."""

    model: nn.Module
    optimizer: AdamW
    step: int = 0


def create_train_state(model: nn.Module, make_opt: Callable) -> TrainState:
    """``make_opt(params)`` builds the optimizer over the model's
    parameters, in ``named_parameters`` order."""
    return TrainState(model, make_opt([p for _, p in
                                       model.named_parameters()]))


def batch_to(batch: Mapping, device) -> Dict:
    """Every array or tensor of a batch on ``device`` (NumPy arrays as
    tensors); other entries as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = (v.to(device, non_blocking=True) if torch.is_tensor(v)
                  else v)
    return out


def _global_norm(grads) -> torch.Tensor:
    """sqrt(sum |g|^2) over ``grads``, in at least f32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.to(torch.promote_types(g.dtype,
                                                           torch.float32)))
         for g in grads]))


def make_train_step(loss_fn: Callable, mark: Optional[Callable] = None,
                    check_unused_params: bool = False):
    """``train_step(state, batch) -> (state, loss, aux)``.

    ``loss_fn(model, params, batch) -> (loss, aux)`` with ``params`` the
    model's parameters by name (:func:`train.builder.make_loss_fn_generic`,
    optionally under :func:`train.amp.bf16_policy`).  ``aux`` gains
    ``grad_norm``, the gradients' global norm before clipping, and with
    ``check_unused_params`` one ``gnorm/<name>`` per top-level module: the
    global norm of its parameters' gradients (the reference's
    ``GradChecker`` warned on parameters with no gradient; a norm that
    stays 0 says the same; JAX ``train/loop.py:45-78``).  Everything
    returned stays on the device.  ``mark(stage)``, if given, is called
    after the loss, the backward and the optimizer, and after the
    gradients' all-reduce (``'all_reduce'``) when there is more than one
    rank.  A step is the span ``train.step`` over ``train.forward_loss``
    (the batch's upload, the forward and the loss; the loss functions of
    :mod:`train.builder` open ``train.loss`` after the forward),
    ``train.backward``,
    ``train.all_reduce`` (more than one rank) and ``train.optimizer``
    (the clip and AdamW) (``utils/timing.py``).

    Data parallel: the gradients are averaged over the ranks
    (``parallel/mesh.py:all_reduce_gradients``) between ``backward`` and
    the optimizer, so the clip's norm and ``grad_norm`` are the global
    gradient's.  The mean is the gradient of the global loss because
    every loss term is a mean over equal per-rank shares: the anchor
    head's, the DETR and the occupancy losses are per-sample losses
    averaged over the batch, and the two batch-wide statistics, the train-
    mode BatchNorm moments and the depth loss's pixel count, are reduced
    over the ranks inside the forward (``models/layers.py:BatchNorm``,
    ``models/bevfusion.py:depth_dist_loss``).
    """

    def train_step(state: TrainState, batch: Mapping):
        with span('train.step'):
            return step(state, batch)

    def step(state: TrainState, batch: Mapping):
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        device = next(iter(params.values())).device
        with span('train.forward_loss'):
            loss, aux = loss_fn(model, params, batch_to(batch, device))
        if mark is not None:
            mark('loss')
        with span('train.backward'):
            loss.backward()
        if mark is not None:
            mark('backward')
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        if dp.data_parallel_size() > 1:
            with span('train.all_reduce'):
                dp.all_reduce_gradients(grads)
            if mark is not None:
                mark('all_reduce')
        aux = {k: v.detach() for k, v in aux.items()}
        with span('train.optimizer'):
            if check_unused_params:
                groups: Dict[str, list] = {}
                for name, g in zip(params, grads):
                    groups.setdefault(name.split('.')[0], []).append(g)
                for top, gs in groups.items():
                    aux[f'gnorm/{top}'] = _global_norm(gs)
            aux['grad_norm'] = state.optimizer.step(grads)
            for p in params.values():
                p.grad = None
            state.step += 1
        if mark is not None:
            mark('optimizer')
        return state, loss.detach(), aux

    return train_step


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _ckpt_steps(ckpt_dir: str):
    return sorted(int(f[len('ckpt_'):-len('.pt')]) for f in os.listdir(ckpt_dir)
                  if f.startswith('ckpt_') and f.endswith('.pt'))


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    max_keep: int = 3) -> str:
    """Write ``ckpt_<step>.pt`` (model state_dict, optimizer state, step)
    and delete all but the newest ``max_keep`` (reference
    ``max_keep_ckpts=3``); returns the path.  The file is written under a
    temporary name first, so a reader never sees a partial checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f'ckpt_{step}.pt')
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save({'step': state.step, 'model': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    for old in _ckpt_steps(ckpt_dir)[:-max_keep]:
        os.remove(os.path.join(ckpt_dir, f'ckpt_{old}.pt'))
    return path


def checkpoint_file(ckpt_dir: str, step: Optional[int] = None) -> str:
    """A checkpoint file itself, or the newest ``ckpt_<N>.pt`` of a
    directory (``step=N`` picks one)."""
    if os.path.isfile(ckpt_dir):
        if step is not None:
            raise ValueError(f'{ckpt_dir} is itself a checkpoint; step={step} '
                             f'cannot also be applied')
        return ckpt_dir
    steps = _ckpt_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f'no checkpoints in {ckpt_dir}')
    return os.path.join(ckpt_dir,
                        f'ckpt_{steps[-1] if step is None else step}.pt')


def load_checkpoint(ckpt_dir: str, state: TrainState,
                    step: Optional[int] = None) -> TrainState:
    """Restore ``state`` in place from a checkpoint file, or from the
    newest ``ckpt_<N>.pt`` of a directory (``step=N`` picks one)."""
    path = checkpoint_file(ckpt_dir, step)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    state.step = int(payload['step'])
    return state


# ---------------------------------------------------------------------------
# Logging
# ---------------------------------------------------------------------------

class JsonLogger:
    """Append-only ``<name>.log.json`` metric stream (the reference
    TextLoggerHook's ``.log.json``), echoed to stdout.  With more than one
    rank only rank 0 writes and echoes (the reference's ``master_only``
    logger hooks)."""

    def __init__(self, work_dir: str, name: str = 'train'):
        self.writes = dp.data_parallel_rank() == 0
        if self.writes:
            os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, f'{name}.log.json')

    def log(self, record: Dict, echo: bool = True):
        if not self.writes:
            return
        record = {k: (float(v) if isinstance(v, (np.floating, np.ndarray,
                                                 torch.Tensor)) else v)
                  for k, v in record.items()}
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')
        if echo:
            print(', '.join(f'{k}: {v:.4f}' if isinstance(v, float)
                            else f'{k}: {v}' for k, v in record.items()),
                  flush=True)


def _check_finite(value: float, where: str) -> float:
    if not np.isfinite(value):
        raise FloatingPointError(f'non-finite loss at {where}')
    return value


def _read_scalars(loss, aux) -> Dict[str, float]:
    """The loss and the step's scalars in one device-to-host copy; with
    more than one rank, their means over the ranks (every rank reads at
    the same steps, so all of them see, and raise on, the same loss)."""
    values = dp.reduce_scalars({'loss': loss, **aux})
    keys = list(values)
    values = torch.stack([v.detach().double().reshape(())
                          for v in values.values()]).tolist()
    return dict(zip(keys, values))


def run_training(state: TrainState, train_step, train_loader,
                 num_epochs: int, logger: Optional[JsonLogger] = None,
                 log_interval: int = 50, ckpt_dir: Optional[str] = None,
                 ckpt_interval: int = 1, eval_fn: Optional[Callable] = None,
                 eval_interval: int = 1) -> TrainState:
    """Epoch-based runner over an iterable of batches (dicts of arrays or
    tensors); ``train_loader.set_epoch(epoch)`` is called if it exists.
    Batches go through :func:`data.prefetch.prefetch` toward the model's
    device, as in JAX ``loop.py:174-183``; a batch of camera sources
    (``image_decode='device'``) is decoded there, on the card's side
    stream or, on the CPU, by the kernels' plain versions, before
    ``train_step`` sees it.  With more than one rank, rank 0 writes the
    checkpoints and every rank meets the others at a barrier after each;
    ``eval_fn`` runs on every rank (``train/eval_runner.py`` collects
    the ranks' results); pass ``logger`` on rank 0 only."""
    from omnihd_scenes_tpu_torch.data.prefetch import prefetch

    device = next(state.model.parameters()).device
    for epoch in range(num_epochs):
        if hasattr(train_loader, 'set_epoch'):
            train_loader.set_epoch(epoch)
        t0 = time.time()
        loss = None
        checked = False
        for it, batch in enumerate(prefetch(iter(train_loader),
                                            device=device)):
            state, loss, aux = train_step(state, batch)
            checked = it % log_interval == 0
            if checked:
                rec = _read_scalars(loss, aux)
                _check_finite(rec['loss'], f'epoch {epoch} iter {it}')
                if logger:
                    logger.log({'mode': 'train', 'epoch': epoch, 'iter': it,
                                'loss': rec.pop('loss'),
                                'time': time.time() - t0, **rec})
                    t0 = time.time()
        # A non-finite loss after the last logged step must not reach the
        # checkpoint (rotation could evict the last good one).
        if loss is not None and not checked:
            _check_finite(_read_scalars(loss, {})['loss'],
                          f'end of epoch {epoch}')
        if ckpt_dir and (epoch + 1) % ckpt_interval == 0:
            if dp.data_parallel_rank() == 0:
                save_checkpoint(ckpt_dir, state, epoch + 1)
            distributed.barrier()
        if eval_fn and (epoch + 1) % eval_interval == 0:
            metrics = eval_fn(state)
            if logger:
                logger.log({'mode': 'val', 'epoch': epoch, **metrics})
    return state
