"""Serving entry point: BEVFusion forward + box decode + rotated NMS.

The model path of ``bench.py:main`` (batch of camera + radar samples in,
``(boxes, scores, labels, valid)`` per sample out).  The network runs in
``dtype`` (bf16 on the card) with channels_last activations; geometry
(rots, trans), radar points and anchors stay f32 — the JAX bench casts
them to bf16 as well — and decode + NMS run in f32.

int8 PTQ tier (the ``bench.py --int8`` flow): :func:`calibrate` runs
calibration then freeze and returns the quant state; ``Predictor(...,
quant_state=state)`` serves int8, with every eligible 3x3 conv in the
fused int8 kernel (``models/quant.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig, DecodeCfg
from omnihd_scenes_tpu_torch.models.anchor_head import anchor_head_get_bboxes
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.quant import (load_quant_state,
                                                  quant_state, set_mode)
from omnihd_scenes_tpu_torch.ops.lss_project import check_rotations
from omnihd_scenes_tpu_torch.weights import load_state_dict


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    return t.to(device=device, dtype=dtype)


class Predictor:
    """``Predictor(cfg, state_dict, device, dtype)(points, points_mask,
    imgs, rots, trans)`` -> (boxes (B, max_num, 9), scores (B, max_num),
    labels (B, max_num) int32, valid (B, max_num) bool).

    Inputs are NumPy arrays or tensors in the JAX package's layouts:
    points (B, P, 8), points_mask (B, P), imgs (B, N, H, W, 3),
    rots (B, N, 3, 3), trans (B, N, 3); points and mask are None for the
    camera-only model (``radar_stream=False``).

    With ``quant_state`` (from :func:`calibrate`, or the JAX ``quant``
    collection through ``weights.flax_quant_to_torch``) the network runs
    in the int8 PTQ tier.
    """

    def __init__(self, cfg: BEVFusionConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 device='cuda', dtype: torch.dtype = torch.bfloat16,
                 decode_cfg: DecodeCfg = DecodeCfg(),
                 quant_state: Optional[Mapping[str, torch.Tensor]] = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.decode_cfg = decode_cfg
        model = BEVFusion(cfg)
        load_state_dict(model, state_dict)
        self.model = model.to(device=self.device, dtype=dtype,
                              memory_format=torch.channels_last).eval()
        if quant_state is not None:
            load_quant_state(self.model, quant_state)
            set_mode(self.model, 'int8')
        self.anchors = torch.from_numpy(cfg.pillars.anchors()).to(self.device)

    @torch.inference_mode()
    def forward(self, points, points_mask, imgs, rots, trans):
        """The network alone: the model's dict of JAX-layout outputs."""
        dev = self.device
        check_rotations(rots)
        if points is not None:               # None: camera-only model
            points = _as_tensor(points, dev, torch.float32)
            points_mask = _as_tensor(points_mask, dev, torch.bool)
        return self.model(points, points_mask,
                          _as_tensor(imgs, dev, self.dtype),
                          _as_tensor(rots, dev, torch.float32),
                          _as_tensor(trans, dev, torch.float32))

    @torch.inference_mode()
    def __call__(self, points, points_mask, imgs, rots, trans):
        out = self.forward(points, points_mask, imgs, rots, trans)
        return anchor_head_get_bboxes(
            out['cls_score'].float(), out['bbox_pred'].float(),
            out['dir_pred'].float(), self.anchors, self.decode_cfg)


def calibrate(cfg: BEVFusionConfig, state_dict: Mapping[str, torch.Tensor],
              requests: Sequence, device='cuda',
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """PTQ calibration as ``bench.py --int8`` runs it: every request
    through the network in ``calib`` mode (running max|x| per quantized
    conv), then the last one in ``freeze`` mode (int8 weights from the
    weights in ``dtype``).  Returns the quant state, on ``device``."""
    if not requests:
        raise ValueError('calibrate needs at least one request')
    predictor = Predictor(cfg, state_dict, device=device, dtype=dtype)
    set_mode(predictor.model, 'calib')
    for request in requests:
        predictor.forward(*request)
    set_mode(predictor.model, 'freeze')
    predictor.forward(*requests[-1])
    return quant_state(predictor.model)
