"""Seeded random weights, made on the device in a few large calls.

The layout comes from the benchmark's own reference model (built on the
``meta`` device), whose parameter names are the port's.  The rules are
flax's initialisation as the port's ``weights.py:init_weights`` and
``models/bevformer/detector.py:init_bevformer`` draw it: LeCun-normal
conv and linear kernels, zero biases, identity BatchNorms and
LayerNorms, N(0, 1) learned embeddings, U[0, 1) positional row and column
embeddings; the deformable attentions' offset and weight kernels
N(0, ``offset_std``) with the grid-init offset bias (the configuration's
``assumed`` spread: a trained model's offsets depend on the query).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from perfbench.reference.common import BatchNorm


def _plan(model: nn.Module, offset_std: Optional[float]) -> dict:
    """key -> ('normal', scale) | ('uniform', None) | ('const', value) |
    ('tensor', values)."""
    plan = {}
    for name, m in model.named_modules():
        p = f'{name}.' if name else ''
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d) else w[0].numel())
            plan[p + 'weight'] = ('normal', fan_in ** -0.5)
            if m.bias is not None:
                plan[p + 'bias'] = ('const', 0.0)
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            plan[p + 'weight'] = ('const', 1.0)
            plan[p + 'bias'] = ('const', 0.0)
            if isinstance(m, BatchNorm):
                plan[p + 'running_mean'] = ('const', 0.0)
                plan[p + 'running_var'] = ('const', 1.0)
                plan[p + 'num_batches_tracked'] = ('const', 0)
    for name, m in model.named_modules():
        if hasattr(m, 'offset_bias') and offset_std is not None:
            p = f'{name}.'
            plan[p + 'sampling_offsets.weight'] = ('normal', offset_std)
            plan[p + 'sampling_offsets.bias'] = (
                'tensor', torch.from_numpy(m.offset_bias()))
            plan[p + 'attention_weights.weight'] = ('normal', offset_std)
            plan[p + 'attention_weights.bias'] = ('const', 0.0)
    for key in model.state_dict():
        if key not in plan:                 # a learned embedding
            plan[key] = (('uniform', None)
                         if key.endswith(('row_embed', 'col_embed'))
                         else ('normal', 1.0))
    return plan


def seeded_state_dict(model: nn.Module, seed: int, device,
                      dtype: torch.dtype,
                      offset_std: Optional[float] = None
                      ) -> Dict[str, torch.Tensor]:
    """A state dict of ``model``'s layout (``model`` may live on the meta
    device) drawn from ``seed`` on ``device``: float entries in ``dtype``,
    so that a reference reading them in f32 sees the served values."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    plan = _plan(model, offset_std)
    keys = sorted(shapes)
    n_normal = sum(shapes[k].numel() for k in keys
                   if plan[k][0] == 'normal')
    n_uniform = sum(shapes[k].numel() for k in keys
                    if plan[k][0] == 'uniform')
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, offs = {}, {'normal': 0, 'uniform': 0}
    for k in keys:
        kind, arg = plan[k]
        shape = shapes[k]
        if kind in offs:
            flat = normal if kind == 'normal' else uniform
            o = offs[kind]
            t = flat[o:o + shape.numel()].view(shape)
            offs[kind] = o + shape.numel()
            out[k] = (t * arg if kind == 'normal' else t).to(dtype)
        elif kind == 'tensor':
            out[k] = arg.to(device=device, dtype=dtype).view(shape)
        elif k.endswith('num_batches_tracked'):
            out[k] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            out[k] = torch.full(shape, arg, dtype=dtype, device=device)
    return out
