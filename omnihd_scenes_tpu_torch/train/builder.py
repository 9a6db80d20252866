"""The training loss (counterpart of ``omnihd_scenes_tpu/train/builder.py:
make_loss_fn_generic``), for the ``bevfusion`` family.

The batch is the JAX package's: ``points`` (B, P, 8), ``points_mask``,
``imgs`` (B, N, H, W, 3), ``img2lidar_rots`` / ``img2lidar_trans``,
``gt_boxes`` (B, G, 9), ``gt_labels``, ``gt_mask``, and optionally
``depth_gaussian`` (B, N, fH, fW, D) with ``depth_min`` (B, N, fH, fW).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from omnihd_scenes_tpu_torch.models.anchor_head import (HeadLossConfig,
                                                        anchor_head_loss)
from omnihd_scenes_tpu_torch.models.bevfusion import depth_dist_loss

FAMILIES = ('bevfusion',)


def make_loss_fn_generic(model, mtype: str, anchors_np: np.ndarray,
                         depth_loss_weight: float = 1.0,
                         camera_depth_range=(1.0, 60.0, 1.0),
                         mark: Optional[Callable] = None) -> Callable:
    """``loss_fn(model, params, batch) -> (loss, aux)``: the anchor head's
    focal + smooth-L1 + direction losses (each sample's normalised by its
    positives, then the batch mean), plus ``depth_loss_weight`` times the
    depth-distribution loss when the batch has ``depth_gaussian``.

    ``params`` maps the model's parameter names to the tensors the forward
    uses (``functional_call``; None: the model's own); the model's
    BatchNorm buffers are updated in place when it is in train mode.
    ``mark('forward')``, if given, is called between the forward and the
    loss (see :func:`train.loop.make_train_step`).  Families other than
    ``bevfusion`` are not ported yet.
    """
    if mtype not in FAMILIES:
        raise NotImplementedError(f'loss of model_type {mtype!r} is not '
                                  f'ported yet (only {FAMILIES})')
    losses = DetectionLosses(anchors_np, depth_loss_weight,
                             camera_depth_range)

    def loss_fn(model, params: Optional[Mapping[str, torch.Tensor]], batch):
        out = forward(model, params, batch)
        if mark is not None:
            mark('forward')
        return losses(out, batch)

    return loss_fn


def forward(model, params: Optional[Mapping[str, torch.Tensor]], batch):
    """The model's outputs on a batch, with ``params`` in place of its own
    parameters (None: its own)."""
    inputs = (batch['points'], batch['points_mask'], batch['imgs'],
              batch['img2lidar_rots'], batch['img2lidar_trans'])
    return (model(*inputs) if params is None
            else functional_call(model, dict(params), inputs))


class DetectionLosses:
    """``(outputs, batch) -> (total, aux)`` of the bevfusion family.

    The loss terms are evaluated in at least f32: the outputs they read
    and the depth targets are upcast first (under the bf16 policy, f32
    losses of bf16 outputs).  The JAX package evaluates them in the
    outputs' own dtype under its bf16 policy
    (``omnihd_scenes_tpu/train/amp.py``); on the mini configuration the
    two choices move one bf16 step's gradient by far less than bf16 does
    (``tests/test_torch_port_bf16_step.py``).
    """

    def __init__(self, anchors_np: np.ndarray, depth_loss_weight: float,
                 camera_depth_range):
        self.head_cfg = HeadLossConfig()
        self.anchors = torch.from_numpy(np.asarray(anchors_np, np.float32))
        self.depth_loss_weight = depth_loss_weight
        self.camera_depth_range = camera_depth_range

    @staticmethod
    def _upcast(t):
        return t.to(torch.promote_types(t.dtype, torch.float32))

    def __call__(self, out, batch):
        up = self._upcast
        dev = out['cls_score'].device
        if self.anchors.device != dev:
            self.anchors = self.anchors.to(dev)
        aux = anchor_head_loss(up(out['cls_score']), up(out['bbox_pred']),
                               up(out['dir_pred']), self.anchors,
                               batch['gt_boxes'], batch['gt_labels'],
                               batch['gt_mask'], self.head_cfg)
        total = aux['loss_cls'] + aux['loss_bbox'] + aux['loss_dir']
        if 'depth_gaussian' in batch and out.get('depth') is not None:
            dl = depth_dist_loss(up(out['depth']),
                                 up(batch['depth_gaussian']),
                                 batch['depth_min'], self.camera_depth_range)
            aux['loss_depth'] = dl
            total = total + self.depth_loss_weight * dl
        return total, aux
