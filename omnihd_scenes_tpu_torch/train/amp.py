"""Mixed precision training (counterpart of ``omnihd_scenes_tpu/train/amp.py``):
bf16 compute, f32 state.

:func:`bf16_policy` wraps a ``loss_fn(model, params, batch)``: the forward
gets bf16 copies of the f32 parameters and of every f32 batch entry
(points, images, geometry, GT boxes, depth targets; masks and labels keep
their dtypes), exactly the set the JAX policy casts.  The copies are made
with ``.to()``, which autograd differentiates, so the gradients arrive on
the f32 parameters already upcast.  BatchNorm's running statistics stay
f32 buffers of the model (the JAX ``batch_stats`` are not cast either)
and are updated in f32; the loss comes back in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch


def to_bf16(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every f32 tensor of a flat mapping cast to bf16; the rest as is."""
    return {k: v.to(torch.bfloat16) if torch.is_tensor(v)
            and v.dtype == torch.float32 else v for k, v in tree.items()}


def bf16_policy(loss_fn: Callable) -> Callable:
    """``loss_fn(model, params, batch) -> (loss, aux)`` under the
    bf16-compute / f32-state policy."""

    def wrapped(model, params, batch):
        loss, aux = loss_fn(model, to_bf16(params), to_bf16(batch))
        return loss.float(), {k: v.float() for k, v in aux.items()}

    return wrapped
