"""Process groups and result collection (counterpart of
``omnihd_scenes_tpu/parallel/distributed.py``).

Parity targets:

- ``init_dist`` (mmcv NCCL process groups, reference ``tools/train.py:
  179-186``), which the JAX package maps to ``jax.distributed.initialize``
  -> :func:`init_distributed`: ``torch.distributed`` from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), NCCL for CUDA and gloo for the CPU; it registers the
  data-parallel group (``parallel/mesh.py``);
- ``collect_results_cpu`` (per-rank pickles to a tmpdir + barrier +
  rank-0 ordered concat, reference ``apis/test.py:119-163``), which the
  JAX package maps to ``process_allgather`` -> :func:`collect_results`:
  the JAX package's rules, over a gloo group on host arrays even when the
  device group is NCCL.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from omnihd_scenes_tpu_torch.parallel import mesh

_HOST_GROUP = None


def init_distributed(device_type: str = 'cuda', backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Dict[str, int]:
    """Join the process group torchrun describes (or the one the arguments
    give) and register it as the data-parallel group.

    Nothing is initialised when ``WORLD_SIZE`` is unset or 1 and no
    argument asks for a group: one process needs none.  ``backend``
    defaults to NCCL for ``device_type='cuda'`` and gloo for the CPU.
    Returns the JAX package's dict: ``process_index``, ``process_count``,
    ``local_devices``, ``global_devices`` (one device a process)."""
    global _HOST_GROUP
    world = int(os.environ.get('WORLD_SIZE', '1')) if world_size is None \
        else world_size
    explicit = (init_method, rank, world_size, backend) != (None,) * 4
    if (world > 1 or explicit) and not dist.is_initialized():
        backend = backend or ('nccl' if device_type == 'cuda' else 'gloo')
        dist.init_process_group(
            backend, init_method=init_method or 'env://', world_size=world,
            rank=int(os.environ.get('RANK', '0')) if rank is None else rank)
        # Host arrays are collected over gloo, as collect_results_cpu
        # collects through the file system beside an NCCL group.
        _HOST_GROUP = (dist.group.WORLD if backend == 'gloo'
                       else dist.new_group(backend='gloo'))
        mesh.set_data_parallel_group(dist.group.WORLD)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {'process_index': dist.get_rank() if dist.is_initialized() else 0,
            'process_count': count,
            'local_devices': int(os.environ.get('LOCAL_WORLD_SIZE', '1')),
            'global_devices': count}


def destroy_distributed() -> None:
    """Leave the process group and clear the registered groups."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    mesh.set_data_parallel_group(None)


def backend() -> str:
    """The device group's backend, or ``'none'`` for one process."""
    return dist.get_backend() if dist.is_initialized() else 'none'


def _pad_local(local_results: List[Dict[str, np.ndarray]],
               keys: List[str], max_n: int) -> Dict[str, np.ndarray]:
    """Stack a rank's results per key and zero-pad to ``max_n`` rows."""
    local = {k: np.stack([np.asarray(r[k]) for r in local_results])
             for k in keys}
    n = len(local_results)
    if n < max_n:
        local = {k: np.concatenate(
            [v, np.zeros((max_n - n,) + v.shape[1:], v.dtype)])
            for k, v in local.items()}
    return local


def _host_allgather(x):
    """Every rank's ``x`` (an array, or a dict of arrays with the same keys
    on every rank), stacked on a new leading axis; each array travels as
    its bytes over the gloo group."""
    group = _HOST_GROUP
    world = dist.get_world_size(group)

    def gather(a):
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t, group=group)
        return np.stack([o.numpy().view(a.dtype).reshape(a.shape)
                         for o in out])

    if isinstance(x, np.ndarray):
        return gather(x)
    return {k: gather(v) for k, v in x.items()}


def collect_results(local_results: List[Dict[str, np.ndarray]],
                    total_size: Optional[int] = None,
                    _allgather=None,
                    _process_count: Optional[int] = None) -> List[Dict]:
    """Gather per-rank result lists into one rank-ordered list, on every
    rank.

    Ranks infer contiguous blocks of the dataset
    (``data/loader.py:EvalLoader``), so rank-ordered concatenation is the
    dataset's order; ``total_size`` trims the wrapped padding of the last
    block.  Ragged-safe: each rank zero-pads to the largest count before
    the gather, and the padding is dropped by the gathered counts.
    Identity on one process.  ``_allgather`` / ``_process_count`` are
    injectable for tests (the JAX package's signature)."""
    process_count = (_process_count if _process_count is not None
                     else (dist.get_world_size(_HOST_GROUP)
                           if _HOST_GROUP is not None else 1))
    if process_count == 1:
        return list(local_results)
    _allgather = _allgather or _host_allgather
    counts = np.asarray(
        _allgather(np.asarray([len(local_results)], np.int64))
    ).reshape(process_count)
    max_n = int(counts.max())
    if counts.min() == 0:
        # Raise on EVERY rank (the counts are the same everywhere): one
        # rank raising before the payload gather would leave the others
        # blocked in it.
        raise RuntimeError(
            f'collect_results: some rank holds zero results '
            f'(counts={counts.tolist()}); shard the eval set so every '
            'rank gets at least one sample')
    keys = sorted(local_results[0].keys())
    gathered = _allgather(_pad_local(local_results, keys, max_n))
    out: List[Dict] = []
    for rank in range(process_count):
        for i in range(int(counts[rank])):
            out.append({k: gathered[k][rank, i] for k in keys})
    if total_size is not None:
        out = out[:total_size]
    return out


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank (itself on one process)."""
    if _HOST_GROUP is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def barrier() -> None:
    """Every rank waits for the others (reference ``dist.barrier``,
    ``apis/test.py:141``); nothing on one process."""
    if _HOST_GROUP is not None:
        dist.barrier(group=_HOST_GROUP)
