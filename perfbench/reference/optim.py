"""Plain float32 reference of the training recipe's optimizer: gradients
clipped to a global norm, then AdamW with decoupled weight decay on every
parameter, under a linear warm-up then cosine learning rate.

What optax's ``chain(clip_by_global_norm, adamw)`` computes, as the
reference configs set it (``configs/bevfusion.py``), written out per
tensor: ``g * max / |g|`` when ``|g| >= max``; moments ``(1 - b) g + b
m``; bias corrections ``1 - b^t`` in f32; ``u = m_hat / (sqrt(v_hat) +
eps) + wd * p``; ``p -= lr * u``, the rate read at the update count
before it increments.  Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine(base_lr: float, total_steps: int, warmup_iters: int,
                  warmup_ratio: float,
                  min_lr_ratio: float = 1e-3) -> Callable[[int], float]:
    """Update count -> rate: linear from ``base_lr * warmup_ratio`` to
    ``base_lr`` over ``warmup_iters``, then cosine down to ``base_lr *
    min_lr_ratio`` over the rest."""
    def schedule(count: int) -> float:
        if count < warmup_iters:
            frac = 1 - count / max(warmup_iters, 1)
            return (base_lr * warmup_ratio - base_lr) * frac + base_lr
        rest = max(total_steps - warmup_iters, 1)
        t = min(count - warmup_iters, rest)
        cosine = 0.5 * (1 + math.cos(math.pi * t / rest))
        return base_lr * ((1 - min_lr_ratio) * cosine + min_lr_ratio)
    return schedule


class AdamW:
    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float,
                 grad_clip_norm: float):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = grad_clip_norm
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Update the parameters; returns the clipped gradients."""
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads))
        scale = 1.0 if norm < self.clip else self.clip / norm
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1) - f32(B2) ** f32(self.count))
        clipped = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * scale
            clipped.append(g)
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (m / bc1) / ((v / bc2).sqrt() + EPS) + self.weight_decay * p
            p.sub_(lr * u)
        return clipped
