"""Model registry: config -> model, loss and prediction functions
(counterpart of ``omnihd_scenes_tpu/train/builder.py``).

A config's ``model_type`` selects the family:

- ``pointpillars`` / ``radarpillarnet``: single-modality pillar detectors
  (radar or LiDAR points);
- ``lss`` / ``bevfusion`` / ``rcfusion``: the camera-only and the camera
  + radar fusion detectors (RCFusion: ``rc_fusion='cross_attention'`` by
  default), with the depth-distribution loss when the batch has depth
  targets;
- ``bevfusion_mtl``: BEVFusion-OCC, fusion + semantic occupancy, with
  the occupancy losses when the batch has ``gt_occ``;
- ``bevformer``: BEVFormer-T (R50, or R101 with DCNv2 stages), the
  temporal camera DETR detector: trained on frame queues with the
  Hungarian-matched loss, served one frame per call
  (:func:`make_predict_fn_generic` gives the streaming predict function).

Batches are the JAX package's: ``points`` (B, P, D) and ``points_mask``
for the point families and the fusion models; ``imgs`` (B, N, H, W, 3),
``img2lidar_rots`` / ``img2lidar_trans`` for the camera families;
``gt_boxes`` (B, G, 9), ``gt_labels``, ``gt_mask`` for training, and
optionally ``depth_gaussian`` (B, N, fH, fW, D) with ``depth_min``, and
``gt_occ`` (B, Dx, Dy, Dz).  A BEVFormer batch is a queue per sample:
``imgs`` (B, Q, N, H, W, 3), ``can_bus`` (B, Q, 18) relative,
``lidar2img`` (B, Q, N, 4, 4) and ``has_prev`` (B, Q) bool.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from omnihd_scenes_tpu_torch.config import (BEVFormerConfig, BEVFusionConfig,
                                            DecodeCfg, LSSConfig, MTLConfig,
                                            PointPillarsConfig)
from omnihd_scenes_tpu_torch.models.anchor_head import (
    HeadLossConfig, anchor_head_decode_candidates, anchor_head_get_bboxes,
    anchor_head_loss)
from omnihd_scenes_tpu_torch.models.bbox_coder import NMSFreeCoderCfg
from omnihd_scenes_tpu_torch.models.bevformer import (BEVFormerDetector,
                                                      DETRLossCfg,
                                                      bevformer_head_loss,
                                                      init_bevformer)
from omnihd_scenes_tpu_torch.models.bevfusion import (BEVFusion,
                                                      depth_dist_loss)
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL
from omnihd_scenes_tpu_torch.models.occ_head import occ_head_loss
from omnihd_scenes_tpu_torch.ops.nms_host import (
    nms_rotated_multiclass_host_batch)
from omnihd_scenes_tpu_torch.serve.predictor import predict_stream
from omnihd_scenes_tpu_torch.serve.synthetic import (random_queue_batch,
                                                     random_request)
from omnihd_scenes_tpu_torch.train.loop import batch_to
from omnihd_scenes_tpu_torch.weights import init_weights

PILLAR_FAMILIES = ('pointpillars', 'radarpillarnet')
CAMERA_FAMILIES = ('lss', 'bevfusion', 'rcfusion', 'bevfusion_mtl')
ANCHOR_FAMILIES = PILLAR_FAMILIES + CAMERA_FAMILIES
FAMILIES = ANCHOR_FAMILIES + ('bevformer',)


def check_family(mtype: str) -> None:
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
    if mtype == 'bevformer':
        return BEVFormerDetector(BEVFormerConfig(**mdict)), mtype
    train = cfg.get('data', {}).get('train', {})
    dims = point_dim(train) if train.get('modality') != 'camera' else 8
    if mtype in PILLAR_FAMILIES:
        if mtype == 'radarpillarnet':
            mdict.setdefault('with_velocity_snr_center', True)
        return PointPillars(PointPillarsConfig(**mdict), dims), mtype
    lss_cfg = LSSConfig(**mdict.pop('lss', {}))
    pillars = PointPillarsConfig(**mdict.pop('pillars', {}))
    occ = {k: mdict.pop(k) for k in ('occ_classes', 'occ_dz') if k in mdict}
    task_w = mdict.pop('task_weights', (1.0, 1.0))
    if mtype == 'lss':
        mdict.setdefault('radar_stream', False)
        mdict.setdefault('lc_fusion', False)
        mdict.setdefault('se', False)
    if mtype == 'rcfusion':
        mdict.setdefault('rc_fusion', 'cross_attention')
    fcfg = BEVFusionConfig(lss=lss_cfg, pillars=pillars, **mdict)
    if mtype == 'bevfusion_mtl':
        return BEVFusionMTL(MTLConfig(fusion=fcfg, task_weights=tuple(task_w),
                                      **occ), dims), mtype
    return BEVFusion(fcfg, dims), mtype


def init_model(model, generator: torch.Generator):
    """The JAX package's ``init_model``: seeded random weights, in place,
    from an explicit ``torch.Generator`` (flax's initialisers)."""
    init_weights(model, generator)
    if isinstance(model, BEVFormerDetector):
        init_bevformer(model, generator)
    return model


EXAMPLE_POINTS = 20000


def example_batch_for(model, mtype: str, device=None) -> tuple:
    """Positional inputs of one forward at the model's widths, batch 1
    (the JAX package's ``example_batch_for``; FLOP counts and parameter
    walks), drawn from ``RandomState(0)``: for the pillar families
    ``EXAMPLE_POINTS`` (20000, as JAX's) points uniform over +-50 m, all
    valid; for the camera families ``serve/synthetic.py:random_request``
    (images, the ring rig and ``EXAMPLE_POINTS`` radar points); for
    BEVFormer one queue of ``random_queue_batch``.  Tensors on
    ``device``; an input the model lacks is None."""
    check_family(mtype)
    rng = np.random.RandomState(0)
    if mtype in PILLAR_FAMILIES:
        pts = rng.uniform(-50, 50, (1, EXAMPLE_POINTS, model.point_dims))
        inputs = (pts.astype(np.float32),
                  np.ones((1, EXAMPLE_POINTS), bool))
    elif mtype == 'bevformer':
        queue = random_queue_batch(rng, model.cfg, 1)
        inputs = tuple(queue[k] for k in ('imgs', 'can_bus', 'lidar2img',
                                          'has_prev'))
    else:
        inputs = random_request(rng, model.cfg, 1, EXAMPLE_POINTS)
    return tuple(None if x is None else torch.from_numpy(x).to(device)
                 for x in inputs)


def anchors_for(model, mtype: str) -> Optional[np.ndarray]:
    """(H, W, A, 9) anchor grid of an anchor-head family (None for the
    DETR head)."""
    check_family(mtype)
    if mtype == 'bevformer':
        return None
    if mtype in PILLAR_FAMILIES:
        return model.cfg.anchors()
    return model.cfg.pillars.anchors()


def model_inputs(batch: Mapping, mtype: str) -> tuple:
    """The model's positional inputs from a batch (``_model_inputs``)."""
    if mtype in PILLAR_FAMILIES:
        return batch['points'], batch['points_mask']
    if mtype == 'bevformer':
        return (batch['imgs'], batch['can_bus'], batch['lidar2img'],
                batch['has_prev'])
    return tuple(batch.get(k) for k in ('points', 'points_mask', 'imgs',
                                        'img2lidar_rots', 'img2lidar_trans'))


def forward(model, params: Optional[Mapping[str, torch.Tensor]], batch,
            mtype: str = 'bevfusion'):
    """The model's outputs on a batch, with ``params`` in place of its own
    parameters (None: its own)."""
    inputs = model_inputs(batch, mtype)
    return (model(*inputs) if params is None
            else functional_call(model, dict(params), inputs))


def make_loss_fn_generic(model, mtype: str, anchors_np: Optional[np.ndarray],
                         depth_loss_weight: float = 1.0,
                         camera_depth_range=(1.0, 60.0, 1.0),
                         occ_weight: float = 1.0,
                         mark: Optional[Callable] = None) -> Callable:
    """``loss_fn(model, params, batch) -> (loss, aux)``: the anchor head's
    focal + smooth-L1 + direction losses (each sample's normalised by its
    positives, then the batch mean), plus, for the camera families,
    ``depth_loss_weight`` times the depth-distribution loss when the batch
    has ``depth_gaussian``, and for ``bevfusion_mtl`` ``occ_weight`` times
    the occupancy losses when it has ``gt_occ`` (``loss_occ`` and
    ``loss_ssc``, each sample's :func:`occ_head_loss`, then the batch
    mean).  As in JAX, no caller passes ``occ_weight`` and the model's
    ``task_weights`` are not applied.

    For ``bevformer`` (``anchors_np`` None): the queue forward (history
    frames without gradients), then :func:`bevformer_head_loss` per
    sample; the loss is the mean of the samples' totals and ``aux`` holds
    the last decoder layer's ``loss_cls`` / ``loss_bbox``, each the mean
    over samples, as in the JAX package.  The loss reads the head's
    outputs in at least f32 (under the bf16 policy the GT boxes arrive in
    bf16 and are upcast before they are coded).  The matching makes one
    host round trip per call, whatever the batch and the decoder depth.

    ``params`` maps the model's parameter names to the tensors the forward
    uses (``functional_call``; None: the model's own); the model's
    BatchNorm buffers are updated in place when it is in train mode.
    ``mark('forward')``, if given, is called between the forward and the
    loss (see :func:`train.loop.make_train_step`).
    """
    check_family(mtype)
    if mtype == 'bevformer':
        return _bevformer_loss_fn(mark)
    losses = DetectionLosses(anchors_np, depth_loss_weight,
                             camera_depth_range,
                             occ_weight if mtype == 'bevfusion_mtl' else None)

    def loss_fn(model, params: Optional[Mapping[str, torch.Tensor]], batch):
        out = forward(model, params, batch, mtype)
        if mark is not None:
            mark('forward')
        return losses(out, batch)

    return loss_fn


def _bevformer_loss_fn(mark: Optional[Callable]) -> Callable:
    cfg = DETRLossCfg()
    up = DetectionLosses._upcast

    def loss_fn(model, params: Optional[Mapping[str, torch.Tensor]], batch):
        out = forward(model, params, batch, 'bevformer')
        if mark is not None:
            mark('forward')
        losses = bevformer_head_loss(
            up(out['all_cls_scores']), up(out['all_bbox_preds']),
            batch['gt_boxes'], batch['gt_labels'], batch['gt_mask'], cfg)
        aux = {k: losses[k].mean() for k in ('loss_cls', 'loss_bbox')}
        return losses['total'].mean(), aux

    return loss_fn


class DetectionLosses:
    """``(outputs, batch) -> (total, aux)`` of the anchor families, with
    the occupancy terms when ``occ_weight`` is not None.

    The loss terms are evaluated in at least f32: the outputs they read
    and the depth targets are upcast first (under the bf16 policy, f32
    losses of bf16 outputs).  The JAX package evaluates them in the
    outputs' own dtype under its bf16 policy
    (``omnihd_scenes_tpu/train/amp.py``); on the mini configuration the
    two choices move one bf16 step's gradient by far less than bf16 does
    (``tests/test_torch_port_bf16_step.py``).
    """

    def __init__(self, anchors_np: np.ndarray, depth_loss_weight: float,
                 camera_depth_range, occ_weight: Optional[float] = None):
        self.head_cfg = HeadLossConfig()
        self.anchors = torch.from_numpy(np.asarray(anchors_np, np.float32))
        self.depth_loss_weight = depth_loss_weight
        self.camera_depth_range = camera_depth_range
        self.occ_weight = occ_weight

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
        if self.occ_weight is not None and 'gt_occ' in batch:
            logits = up(out['occ_logits'])
            per = [occ_head_loss(logits[i], batch['gt_occ'][i])
                   for i in range(logits.shape[0])]
            for k in ('loss_occ', 'loss_ssc'):
                aux[k] = torch.stack([p[k] for p in per]).mean()
            total = total + self.occ_weight * (aux['loss_occ']
                                               + aux['loss_ssc'])
        return total, aux


def make_predict_fn_generic(model, mtype: str,
                            anchors_np: Optional[np.ndarray] = None,
                            decode_cfg: Optional[DecodeCfg] = None,
                            nms_free_cfg: Optional[NMSFreeCoderCfg] = None,
                            host_nms: bool = False) -> Callable:
    """``predict(model, batch) -> ((boxes (B, max_num, 9), scores, labels,
    valid), occ)``: the eval-mode forward, then decode + rotated NMS in f32
    on the model's device; ``occ`` is the occupancy argmax (B, Dx, Dy, Dz)
    for ``bevfusion_mtl`` and None for the other families.  Batch entries
    may be NumPy arrays.

    ``host_nms`` (anchor families only; JAX ``train/builder.py:236-300``):
    the device work ends at the top-``nms_pre`` candidate decode
    (``anchor_head_decode_candidates``), the candidates come back to the
    host in one copy, and the greedy rotated NMS runs there in the native
    core (``ops/nms_host.py``); the detections are then CPU tensors.

    For ``bevformer``: ``predict(model, imgs, can_bus, lidar2img,
    prev_bev, has_prev) -> ((boxes, scores, labels, valid), bev_embed)``,
    one frame of B streams (``serve/predictor.py:predict_stream``), whose
    decode is NMS-free (``host_nms`` is ignored)."""
    check_family(mtype)
    if mtype == 'bevformer':
        return functools.partial(predict_stream,
                                 coder_cfg=nms_free_cfg or NMSFreeCoderCfg())
    decode_cfg = decode_cfg or DecodeCfg()
    anchors = torch.from_numpy(np.asarray(anchors_np, np.float32))
    on_device = {}                  # the anchors, uploaded once per device

    @torch.inference_mode()
    def predict(model, batch):
        model.eval()
        dev = next(model.parameters()).device
        if dev not in on_device:
            on_device[dev] = anchors.to(dev)
        out = model(*model_inputs(batch_to(batch, dev), mtype))
        occ = (out['occ_logits'].argmax(-1) if mtype == 'bevfusion_mtl'
               else None)
        head = (out['cls_score'].float(), out['bbox_pred'].float(),
                out['dir_pred'].float(), on_device[dev], decode_cfg)
        if not host_nms:
            return anchor_head_get_bboxes(*head), occ
        boxes, scores = anchor_head_decode_candidates(*head)
        cand = torch.cat([boxes, scores], -1).cpu().numpy()
        d = boxes.shape[-1]
        dets = nms_rotated_multiclass_host_batch(
            cand[..., :d], cand[..., d:], decode_cfg.score_thr,
            decode_cfg.nms_thr, decode_cfg.max_num)
        return tuple(torch.from_numpy(x) for x in dets), occ

    return predict
