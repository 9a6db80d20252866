"""How a served request is cast and uploaded: one set of rules for the live
``Predictor`` (``serve/predictor.py``) and a loaded bundle
(``serve/export.py:ExportedModel``), which imports no model code.

Images go in the model's dtype, the points mask as bool, points and
geometry (rots, trans) in f32 (ROADMAP queue 3 item 1).  A BEVFormer-T
queue likewise: ``imgs_queue`` in the model's dtype, ``has_prev_queue``
bool, the CAN bus and ``lidar2img`` f32, as ``predict_stream`` casts a
frame (item 21; JAX's ``_to_bf16`` casts every f32 input of a bf16
export).  The camera
rotations are checked on the host before the upload
(``ops/lss_project.py:check_rotations``), outside any traced program.
The upload is the span ``serve.upload`` (the check its child
``serve.check_rotations``) and counts the bytes it is handed
(``serve.upload_bytes``, ``utils/timing.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from omnihd_scenes_tpu_torch.ops.lss_project import check_rotations
from omnihd_scenes_tpu_torch.utils.timing import count, span

# The positional inputs of the radar-only (pillar) families and of the
# camera families, BEVFusion's order.
PILLAR_INPUTS = ('points', 'points_mask')
CAMERA_INPUTS = ('points', 'points_mask', 'imgs', 'rots', 'trans')
# BEVFormer-T's queue forward (models/bevformer/detector.py:forward).
BEVFORMER_INPUTS = ('imgs_queue', 'can_bus_queue', 'lidar2img_queue',
                    'has_prev_queue')


def input_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of input ``name`` for a model served in ``dtype``."""
    return {'imgs': dtype, 'imgs_queue': dtype, 'points_mask': torch.bool,
            'has_prev_queue': torch.bool}.get(name, torch.float32)


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))
    return t.to(device=device, dtype=dtype)


def upload(names: Sequence[str], inputs: Sequence, device,
           dtype: torch.dtype) -> list:
    """``inputs`` (NumPy arrays, tensors or None, in the order of
    ``names``) cast by :func:`input_dtype` and moved to ``device``; None
    stays None and ``rots`` is checked on the host first."""
    out = []
    with span('serve.upload'):
        for name, x in zip(names, inputs):
            if x is None:
                out.append(None)
                continue
            count('serve.upload_bytes', x.nbytes if torch.is_tensor(x)
                  else np.asarray(x).nbytes)
            if name == 'rots':
                with span('serve.check_rotations'):
                    check_rotations(x)
            out.append(as_tensor(x, device, input_dtype(name, dtype)))
    return out
