"""Model registry: config -> model, loss and prediction functions
(counterpart of ``omnihd_scenes_tpu/train/builder.py``).

A config's ``model_type`` selects the family:

- ``pointpillars`` / ``radarpillarnet``: single-modality pillar detectors
  (radar or LiDAR points);
- ``lss`` / ``bevfusion``: the camera-only and the camera + radar fusion
  detectors, with the depth-distribution loss when the batch has depth
  targets.

``rcfusion``, ``bevfusion_mtl`` and ``bevformer`` are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.

Batches are the JAX package's: ``points`` (B, P, D) and ``points_mask``
for the point families and the fusion model; ``imgs`` (B, N, H, W, 3),
``img2lidar_rots`` / ``img2lidar_trans`` for the camera families;
``gt_boxes`` (B, G, 9), ``gt_labels``, ``gt_mask`` for training, and
optionally ``depth_gaussian`` (B, N, fH, fW, D) with ``depth_min``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from omnihd_scenes_tpu_torch.config import (BEVFusionConfig, DecodeCfg,
                                            LSSConfig, PointPillarsConfig)
from omnihd_scenes_tpu_torch.models.anchor_head import (HeadLossConfig,
                                                        anchor_head_get_bboxes,
                                                        anchor_head_loss)
from omnihd_scenes_tpu_torch.models.bevfusion import (BEVFusion,
                                                      depth_dist_loss)
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.train.loop import batch_to
from omnihd_scenes_tpu_torch.weights import init_weights

PILLAR_FAMILIES = ('pointpillars', 'radarpillarnet')
CAMERA_FAMILIES = ('lss', 'bevfusion')
FAMILIES = PILLAR_FAMILIES + CAMERA_FAMILIES
UNPORTED = {'rcfusion': 'ROADMAP queue 1 item 5 (RCFusion)',
            'bevfusion_mtl': 'ROADMAP queue 1 item 5 (MTL-OCC)',
            'bevformer': 'ROADMAP queue 1 item 6 (BEVFormer-T)'}


def check_family(mtype: str) -> None:
    if mtype in UNPORTED:
        raise NotImplementedError(f'model_type {mtype!r} is not ported yet: '
                                  f'{UNPORTED[mtype]}')
    if mtype not in FAMILIES:
        raise ValueError(f'unknown model_type {mtype!r}')


def point_dim(ds_cfg: Mapping) -> int:
    """The point width a dataset config yields, with the dataset's
    defaults (``data/dataset.py:NewScenesDetDataset.point_dim``): radar
    ``len(radar_use_dim)``; LiDAR ``lidar_use_dim``, plus the time-lag
    channel when ``lidar_sweeps > 0``."""
    if ds_cfg.get('modality', 'radar') == 'radar':
        return len(ds_cfg.get('radar_use_dim', range(8)))
    return (int(ds_cfg.get('lidar_use_dim', 4))
            + (1 if int(ds_cfg.get('lidar_sweeps', 0)) > 0 else 0))


def build_model_from_cfg(cfg) -> Tuple[torch.nn.Module, str]:
    """``cfg.model_type`` + ``cfg.model`` -> (module on the CPU, family).

    The PFN's input width is the training dataset's point width."""
    mtype = cfg.get('model_type', 'pointpillars')
    check_family(mtype)
    mdict = cfg.model.to_dict()
    train = cfg.get('data', {}).get('train', {})
    dims = point_dim(train) if train.get('modality') != 'camera' else 8
    if mtype in PILLAR_FAMILIES:
        if mtype == 'radarpillarnet':
            mdict.setdefault('with_velocity_snr_center', True)
        return PointPillars(PointPillarsConfig(**mdict), dims), mtype
    lss_cfg = LSSConfig(**mdict.pop('lss', {}))
    pillars = PointPillarsConfig(**mdict.pop('pillars', {}))
    if mtype == 'lss':
        mdict.setdefault('radar_stream', False)
        mdict.setdefault('lc_fusion', False)
        mdict.setdefault('se', False)
    fcfg = BEVFusionConfig(lss=lss_cfg, pillars=pillars, **mdict)
    return BEVFusion(fcfg, dims), mtype


# The JAX package's ``init_model``: seeded random weights, in place, from
# an explicit ``torch.Generator``.
init_model = init_weights


def anchors_for(model, mtype: str) -> np.ndarray:
    """(H, W, A, 9) anchor grid of an anchor-head family."""
    check_family(mtype)
    if mtype in PILLAR_FAMILIES:
        return model.cfg.anchors()
    return model.cfg.pillars.anchors()


def model_inputs(batch: Mapping, mtype: str) -> tuple:
    """The model's positional inputs from a batch (``_model_inputs``)."""
    if mtype in PILLAR_FAMILIES:
        return batch['points'], batch['points_mask']
    return (batch.get('points'), batch.get('points_mask'), batch['imgs'],
            batch['img2lidar_rots'], batch['img2lidar_trans'])


def forward(model, params: Optional[Mapping[str, torch.Tensor]], batch,
            mtype: str = 'bevfusion'):
    """The model's outputs on a batch, with ``params`` in place of its own
    parameters (None: its own)."""
    inputs = model_inputs(batch, mtype)
    return (model(*inputs) if params is None
            else functional_call(model, dict(params), inputs))


def make_loss_fn_generic(model, mtype: str, anchors_np: np.ndarray,
                         depth_loss_weight: float = 1.0,
                         camera_depth_range=(1.0, 60.0, 1.0),
                         mark: Optional[Callable] = None) -> Callable:
    """``loss_fn(model, params, batch) -> (loss, aux)``: the anchor head's
    focal + smooth-L1 + direction losses (each sample's normalised by its
    positives, then the batch mean), plus, for the camera families,
    ``depth_loss_weight`` times the depth-distribution loss when the batch
    has ``depth_gaussian``.

    ``params`` maps the model's parameter names to the tensors the forward
    uses (``functional_call``; None: the model's own); the model's
    BatchNorm buffers are updated in place when it is in train mode.
    ``mark('forward')``, if given, is called between the forward and the
    loss (see :func:`train.loop.make_train_step`).
    """
    check_family(mtype)
    losses = DetectionLosses(anchors_np, depth_loss_weight,
                             camera_depth_range)

    def loss_fn(model, params: Optional[Mapping[str, torch.Tensor]], batch):
        out = forward(model, params, batch, mtype)
        if mark is not None:
            mark('forward')
        return losses(out, batch)

    return loss_fn


class DetectionLosses:
    """``(outputs, batch) -> (total, aux)`` of the anchor families.

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


def make_predict_fn_generic(model, mtype: str, anchors_np: np.ndarray,
                            decode_cfg: Optional[DecodeCfg] = None
                            ) -> Callable:
    """``predict(model, batch) -> (boxes (B, max_num, 9), scores, labels,
    valid)``: the eval-mode forward, then decode + rotated NMS in f32 on
    the model's device.  Batch entries may be NumPy arrays.  The JAX
    package's ``host_nms`` (its native C++ host NMS) is not ported."""
    check_family(mtype)
    decode_cfg = decode_cfg or DecodeCfg()
    anchors = torch.from_numpy(np.asarray(anchors_np, np.float32))

    @torch.inference_mode()
    def predict(model, batch):
        model.eval()
        dev = next(model.parameters()).device
        out = model(*model_inputs(batch_to(batch, dev), mtype))
        return anchor_head_get_bboxes(
            out['cls_score'].float(), out['bbox_pred'].float(),
            out['dir_pred'].float(), anchors.to(dev), decode_cfg)

    return predict
