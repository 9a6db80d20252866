"""Learning-rate schedule and optimizer (counterpart of
``omnihd_scenes_tpu/train/optim.py``, which builds them from optax).

The reference's optimizer configs: AdamW (weight decay 0.01, decoupled,
on every parameter, as optax's ``adamw`` applies it), gradients clipped
to a global norm of 35 first, linear warmup then cosine annealing or step
decay.  Each piece computes what the optax transformation computes, in
its order:

* clip: ``g * max / |g|`` when ``|g| >= max`` (optax's
  ``clip_by_global_norm``; not ``torch.nn.utils.clip_grad_norm_``, whose
  ``+ 1e-6`` differs); the norm stays on the device, nothing syncs;
* Adam moments ``(1 - b) g + b m``, bias corrections ``1 - b^t`` in f32,
  ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``, ``p -= lr * u``;
* the schedule is read at the update count before it increments, as
  optax's ``scale_by_learning_rate`` reads it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# optax.adamw's moment decays and epsilon.
B1, B2, EPS = 0.9, 0.999, 1e-8


def _linear(init_value, end_value, steps):
    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine(init_value, decay_steps, alpha):
    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def _piecewise_constant(init_value, boundaries_and_scales):
    def schedule(count):
        value = init_value
        for boundary in sorted(boundaries_and_scales):
            if count >= boundary:
                value *= boundaries_and_scales[boundary]
        return value
    return schedule


def make_lr_schedule(base_lr: float,
                     total_steps: int,
                     policy: str = 'cosine',
                     warmup_iters: int = 500,
                     warmup_ratio: float = 1.0 / 3,
                     min_lr_ratio: float = 1e-3,
                     step_epochs: Optional[Sequence[int]] = None,
                     steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Warmup + (cosine | step) schedule: update count -> learning rate."""
    warmup = _linear(base_lr * warmup_ratio, base_lr, max(warmup_iters, 1))
    rest = max(total_steps - warmup_iters, 1)
    if policy == 'cosine':
        main = _cosine(base_lr, rest, min_lr_ratio)
    elif policy == 'step':
        main = _piecewise_constant(base_lr, {
            e * steps_per_epoch - warmup_iters: 0.1
            for e in (step_epochs or [])})
    else:
        raise ValueError(policy)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_iters else main(
            count - warmup_iters)

    return schedule


class AdamW:
    """Global-norm clipping then AdamW over a fixed list of f32 tensors
    (``make_optimizer``'s ``optax.chain(clip_by_global_norm, adamw)``).

    ``step(grads)`` updates the parameters in place and returns the
    gradients' global norm before clipping, as a device scalar.
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.01, grad_clip_norm: float = 35.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        grads = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip_norm,
                            torch.ones_like(norm), self.grad_clip_norm / norm)
        grads = torch._foreach_mul(grads, scale)

        b1, b2 = B1, B2
        lr = self.lr_schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm

    def state_dict(self) -> Dict:
        return {'count': self.count, 'mu': self.mu, 'nu': self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if len(state['mu']) != len(self.params):
            raise ValueError(f'optimizer state for {len(state["mu"])} '
                             f'tensors, not {len(self.params)}')
        self.count = int(state['count'])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state['mu'] + state['nu']):
                dst.copy_(src)


def make_optimizer(params: Sequence[torch.Tensor],
                   lr_schedule: Callable[[int], float],
                   weight_decay: float = 0.01,
                   grad_clip_norm: float = 35.0) -> AdamW:
    """AdamW with global-norm gradient clipping."""
    return AdamW(params, lr_schedule, weight_decay, grad_clip_norm)
