"""Data parallelism over ranks (counterpart of the data axis of
``omnihd_scenes_tpu/parallel/mesh.py``).

The JAX package shards a global batch over a 1-D ``Mesh(('data',))``
(``NamedSharding(P('data'))``) and lets XLA insert the collectives: the
gradient is that of the loss on the whole batch, and flax's BatchNorm and
the depth loss take their statistics over the whole batch.  Here each
rank is a process with its own device (``torchrun``), holding rows
``[r n, (r + 1) n)`` of every global batch, and the same results come from
explicit collectives over the data-parallel group:

* :func:`all_reduce_gradients`: the mean of the ranks' gradients, after
  ``backward`` and before the optimizer's global-norm clip;
* :func:`all_reduce_sum`: a sum over the ranks that gradients flow
  through (its backward sums the incoming gradients), which
  ``models/layers.py:BatchNorm`` and ``models/bevfusion.py:
  depth_dist_loss`` use for their batch-wide statistics;
* :func:`broadcast_state`: rank 0's parameters and buffers at the start,
  as ``DistributedDataParallel`` does;
* :func:`reduce_scalars`: the logged loss and scalars, as means over the
  ranks.

The group is registered once per process (:func:`set_data_parallel_group`,
which ``parallel/distributed.py:init_distributed`` calls); with none, or
with one rank, every helper is the identity and the model's paths are the
one-process ones.  The JAX package's ``model`` axis (GSPMD tensor
parallelism of convs) and its shard_map splat are TPU workarounds and have
no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.distributed as dist

_GROUP = None


def set_data_parallel_group(group) -> None:
    """Register the data-parallel group of this process (None clears it:
    one rank)."""
    global _GROUP
    _GROUP = group


def data_parallel_group():
    """The registered group, or None."""
    return _GROUP


def data_parallel_size() -> int:
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def data_parallel_rank() -> int:
    return 0 if _GROUP is None else dist.get_rank(_GROUP)


def sync_group():
    """The group whose batch statistics BatchNorm and the depth loss share:
    the data-parallel group when it has more than one rank, else None."""
    return _GROUP if data_parallel_size() > 1 else None


def shard_batch(batch: Mapping) -> Dict:
    """This rank's rows ``[r n, (r + 1) n)`` of every array or tensor of a
    global batch (n = rows / ranks), JAX's ``NamedSharding(P('data'))``
    split; other entries as they are.  A batch of camera sources (ragged
    JPEG bytes) is sharded before collation instead, by
    ``data/loader.py:TrainLoader``."""
    rank, size = data_parallel_rank(), data_parallel_size()
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
            if v.shape[0] % size:
                raise ValueError(f'{k}: {v.shape[0]} rows do not split '
                                 f'over {size} ranks')
            n = v.shape[0] // size
            v = v[rank * n:(rank + 1) * n]
        out[k] = v
    return out


def _by_dtype(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flattened buffer per dtype, the result
    copied back into ``tensors`` in place."""
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
            offset += n


def all_reduce_gradients(grads: List[torch.Tensor]) -> None:
    """Replace each gradient by its mean over the ranks, in place: one
    all-reduce of one flattened buffer per dtype.  Identity on one
    rank."""
    size = data_parallel_size()
    if size == 1:
        return

    def mean(flat):
        dist.all_reduce(flat, group=_GROUP)
        flat.div_(size)

    _coalesced(grads, mean)


@torch.no_grad()
def broadcast_state(model: torch.nn.Module) -> None:
    """Every rank's parameters and buffers set to rank 0's, as
    ``DistributedDataParallel`` does at construction.  Identity on one
    rank."""
    if data_parallel_size() == 1:
        return
    tensors = [t for t in model.state_dict(keep_vars=True).values()
               if torch.is_tensor(t)]
    _coalesced([t.data for t in tensors],
               lambda flat: dist.broadcast(flat, 0, group=_GROUP))


def reduce_scalars(values: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each 0-d value as its mean over the ranks (one all-reduce, in f64;
    every rank passes the same keys in the same order).  Identity on one
    rank."""
    size = data_parallel_size()
    if size == 1:
        return dict(values)
    flat = torch.stack([torch.as_tensor(v).detach().double().reshape(())
                        for v in values.values()])
    dist.all_reduce(flat, group=_GROUP)
    flat /= size
    return dict(zip(values, flat.unbind()))


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks; its gradient is the sum over the
    ranks of the incoming gradients, so that the ranks' gradients,
    averaged, are the gradient of the loss averaged over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)
