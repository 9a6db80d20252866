"""Serving entry point: BEVFusion forward + box decode + rotated NMS.

The model path of ``bench.py:main`` (batch of camera + radar samples in,
``(boxes, scores, labels, valid)`` per sample out).  Given an
``MTLConfig`` it serves BEVFusion-OCC (``bench.py --mtl``) and returns
the occupancy argmax (B, Dx, Dy, Dz), a device tensor, after the boxes.
The network runs in ``dtype`` (bf16 on the card) with channels_last
activations; geometry (rots, trans), radar points and anchors stay f32 —
the JAX bench casts them to bf16 as well — and decode + NMS run in f32.

int8 PTQ tier (the ``bench.py --int8`` flow, ``--mtl --int8`` for an
``MTLConfig``): :func:`calibrate` runs calibration then freeze and returns
the quant state; ``Predictor(..., quant_state=state)`` serves int8, with
every eligible 3x3 conv in the fused int8 kernel (``models/quant.py``).
BEVFusion-OCC's occupancy head convs are plain convs in JAX and stay
float here too.

With ``stem_s2d`` (``bench.py --s2d``) the images arrive space-to-depth
packed, (B, N, H/2, W/2, 12) (``models/resnet.py:space_to_depth_np`` on
the host).

:class:`StreamPredictor` serves BEVFormer-T: one frame of B independent
streams per call, the previous BEV carried from call to call (the
counterpart of the JAX package's ``make_predict_fn_generic`` bevformer
branch and ``make_predict_stream_batched``, ``train/builder.py:252-263,
332-351``).

Spans (``utils/timing.py``): a served call is the root ``serve.request``
(``stream.request``) over ``serve.upload`` (``stream.upload``), the
network's own spans and ``serve.decode`` (``stream.decode``); building a
predictor records ``setup.build``, ``setup.load_state_dict`` and
``setup.to_device``.  Counters: ``serve.requests``, ``serve.samples``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import (BEVFormerConfig, BEVFusionConfig,
                                            DecodeCfg, MTLConfig)
from omnihd_scenes_tpu_torch.models.anchor_head import anchor_head_get_bboxes
from omnihd_scenes_tpu_torch.models.bbox_coder import (NMSFreeCoderCfg,
                                                       nms_free_decode)
from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL
from omnihd_scenes_tpu_torch.models.quant import (calibrate_model,
                                                  load_quant_state, set_mode)
from omnihd_scenes_tpu_torch.serve.fuse import (fold_passthroughs,
                                                passthrough_bns)
from omnihd_scenes_tpu_torch.serve.inputs import (CAMERA_INPUTS, as_tensor,
                                                  upload)
from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                     random_stream_frame)
from omnihd_scenes_tpu_torch.utils.timing import count, span
from omnihd_scenes_tpu_torch.weights import load_state_dict


def serving_model(model: torch.nn.Module, device, dtype: torch.dtype,
                  request: Callable[[], Sequence],
                  method: str = 'forward') -> torch.nn.Module:
    """``model`` (weights loaded, on the host) on ``device`` in ``dtype``
    with channels_last activations, in eval mode.  A fused checkpoint's
    passthrough BNs (``serve/fuse.py``; found on the host, before the
    upload) are first folded into their producers in f32, on the device,
    traced on one call of ``model.<method>`` with the positional inputs
    ``request()`` builds (NumPy arrays, tensors or None): a passthrough
    cast to bf16 would scale its input by 0.99771.  An unfused checkpoint
    has none and builds no request.  Raises ``ValueError`` where a
    passthrough the trace cannot fold (no producer, or one that feeds two
    BNs) would be served in another dtype than f32, the one where it is
    exact."""
    names = passthrough_bns(model)
    if names:
        model.to(device)
        run = getattr(model, method)
        inputs = [None if x is None else as_tensor(x, device)
                  for x in request()]
        folded = fold_passthroughs(model, names, lambda: run(*inputs))
        left = [n for n in names if n not in folded]
        if left and dtype != torch.float32:
            raise ValueError(
                f'{len(left)} passthrough BN(s) of a fused checkpoint have '
                f'no producer of their own to fold into ({left[:3]} ...); '
                f'in {dtype} each would scale its input by 0.99771: serve '
                f'this checkpoint in float32')
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()


class Predictor:
    """``Predictor(cfg, state_dict, device, dtype)(points, points_mask,
    imgs, rots, trans)`` -> (boxes (B, max_num, 9), scores (B, max_num),
    labels (B, max_num) int32, valid (B, max_num) bool), and for an
    ``MTLConfig`` then the occupancy argmax (B, Dx, Dy, Dz) int64.

    Inputs are NumPy arrays or tensors in the JAX package's layouts:
    points (B, P, 8), points_mask (B, P), imgs (B, N, H, W, 3) ((B, N,
    H/2, W/2, 12) packed with ``stem_s2d``), rots (B, N, 3, 3), trans (B,
    N, 3); points and mask are None for the camera-only model
    (``radar_stream=False``), imgs, rots and trans for the radar-only one
    (``camera_stream=False``).

    With ``quant_state`` (from :func:`calibrate`, or the JAX ``quant``
    collection through ``weights.flax_quant_to_torch``, or after QAT and
    ``freeze``) the network runs in the int8 tier.  A fused checkpoint
    (``tools/fuse_conv_bn.py``) is served with its passthrough BNs folded
    (:func:`serving_model`, traced on one synthetic b1 request).
    """

    def __init__(self, cfg: Union[BEVFusionConfig, MTLConfig],
                 state_dict: Mapping[str, torch.Tensor],
                 device='cuda', dtype: torch.dtype = torch.bfloat16,
                 decode_cfg: DecodeCfg = DecodeCfg(),
                 quant_state: Optional[Mapping[str, torch.Tensor]] = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.decode_cfg = decode_cfg
        with span('setup.build'):
            model = (BEVFusionMTL(cfg) if isinstance(cfg, MTLConfig)
                     else BEVFusion(cfg))
        fcfg = cfg.fusion if isinstance(cfg, MTLConfig) else cfg
        self.img_channels = 12 if fcfg.stem_s2d else 3
        with span('setup.load_state_dict'):
            load_state_dict(model, state_dict)
        with span('setup.to_device'):
            self.model = serving_model(
                model, self.device, dtype,
                lambda: random_request(np.random.RandomState(0), cfg,
                                       batch=1, n_points=1024))
        if quant_state is not None:
            load_quant_state(self.model, quant_state)
            set_mode(self.model, 'int8')
        self.anchors = torch.from_numpy(cfg.pillars.anchors()).to(self.device)

    @torch.inference_mode()
    def forward(self, points, points_mask, imgs, rots, trans):
        """The network alone: the model's dict of JAX-layout outputs."""
        if imgs is not None and imgs.shape[-1] != self.img_channels:
            raise ValueError(
                f'images of {imgs.shape[-1]} channels; this model takes '
                f'{self.img_channels} (12: space_to_depth packed, '
                f'stem_s2d)')
        points, points_mask, imgs, rots, trans = upload(
            CAMERA_INPUTS, (points, points_mask, imgs, rots, trans),
            self.device, self.dtype)
        return self.model(points, points_mask, imgs, rots, trans)

    @torch.inference_mode()
    def __call__(self, points, points_mask, imgs, rots, trans):
        with span('serve.request'):
            count('serve.requests')
            count('serve.samples', len(rots if points is None else points))
            out = self.forward(points, points_mask, imgs, rots, trans)
            with span('serve.decode'):
                dets = anchor_head_get_bboxes(
                    out['cls_score'].float(), out['bbox_pred'].float(),
                    out['dir_pred'].float(), self.anchors, self.decode_cfg)
                if 'occ_logits' in out:
                    return (*dets, out['occ_logits'].argmax(-1))
            return dets


def calibrate(cfg: Union[BEVFusionConfig, MTLConfig],
              state_dict: Mapping[str, torch.Tensor], requests: Sequence,
              device='cuda',
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """PTQ calibration as ``bench.py --int8`` runs it: every request
    through the network in ``calib`` mode (running max|x| per quantized
    conv), then the last one in ``freeze`` mode (int8 weights from the
    weights in ``dtype``).  Returns the quant state, on ``device``."""
    predictor = Predictor(cfg, state_dict, device=device, dtype=dtype)
    return calibrate_model(predictor.model,
                           lambda request: predictor.forward(*request),
                           requests)


@torch.inference_mode()
def predict_stream(model: BEVFormerDetector, imgs, can_bus, lidar2img,
                   prev_bev, has_prev,
                   coder_cfg: NMSFreeCoderCfg = NMSFreeCoderCfg()):
    """One frame of B streams through ``model`` on its device and in its
    dtype, then the NMS-free decode of the last decoder layer in f32.

    imgs (B, N, H, W, 3); can_bus (B, 18) relative; lidar2img (B, N, 4,
    4); prev_bev (B, bev_h * bev_w, C); has_prev (B,) bool; NumPy arrays
    or tensors.  can_bus, lidar2img and every sampling position stay f32.
    Returns ((boxes (B, max_num, 9), scores, labels, valid), bev_embed
    (B, bev_h * bev_w, C)), all on the device: nothing is read back."""
    model.eval()
    p = model.pts_bbox_head.bev_embedding
    dev, dtype = p.device, p.dtype
    with span('stream.request'):
        with span('stream.upload'):
            inputs = (as_tensor(imgs, dev, dtype),
                      as_tensor(can_bus, dev, torch.float32),
                      as_tensor(lidar2img, dev, torch.float32),
                      as_tensor(prev_bev, dev, dtype),
                      as_tensor(has_prev, dev, torch.bool))
        out = model.forward_stream(*inputs)
        with span('stream.decode'):
            dets = nms_free_decode(out['all_cls_scores'][:, -1],
                                   out['all_bbox_preds'][:, -1], coder_cfg)
    return dets, out['bev_embed']


class StreamPredictor:
    """``StreamPredictor(cfg, state_dict, device, dtype)(imgs, can_bus,
    lidar2img, prev_bev, has_prev)`` -> ((boxes, scores, labels, valid),
    bev_embed): :func:`predict_stream` on a ``BEVFormerDetector(cfg)``
    with ``state_dict``, in ``dtype`` (bf16 on the card) with
    channels_last images.  B = 1 is the latency mode; B > 1 serves B
    independent streams per call (``has_prev`` per stream).  Pass the
    returned ``bev_embed`` back as the next call's ``prev_bev`` and it
    stays on the card; :meth:`zero_bev` is the state of a new stream.  A
    fused checkpoint is served with its passthrough BNs folded
    (:func:`serving_model`, traced on one synthetic b1 frame)."""

    def __init__(self, cfg: BEVFormerConfig,
                 state_dict: Mapping[str, torch.Tensor], device='cuda',
                 dtype: torch.dtype = torch.bfloat16,
                 coder_cfg: NMSFreeCoderCfg = NMSFreeCoderCfg()):
        self.cfg, self.coder_cfg = cfg, coder_cfg
        self.device, self.dtype = torch.device(device), dtype
        with span('setup.build'):
            model = BEVFormerDetector(cfg)
        with span('setup.load_state_dict'):
            load_state_dict(model, state_dict)
        with span('setup.to_device'):
            self.model = serving_model(model, self.device, dtype,
                                       lambda: self._zero_frame(cfg),
                                       method='forward_stream')

    @staticmethod
    def _zero_frame(cfg: BEVFormerConfig):
        """One synthetic b1 frame of a new stream (zero previous BEV),
        ``forward_stream``'s positional inputs, as
        ``tools/fuse_conv_bn.py`` traces a BEVFormer."""
        frame = random_stream_frame(np.random.RandomState(0), cfg, 1)
        return (*frame, np.zeros((1, cfg.bev_h * cfg.bev_w, cfg.embed_dims),
                                 np.float32), np.zeros(1, bool))

    def zero_bev(self, batch: int) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros(batch, cfg.bev_h * cfg.bev_w, cfg.embed_dims,
                           device=self.device, dtype=self.dtype)

    def __call__(self, imgs, can_bus, lidar2img, prev_bev, has_prev):
        return predict_stream(self.model, imgs, can_bus, lidar2img, prev_bev,
                              has_prev, self.coder_cfg)
