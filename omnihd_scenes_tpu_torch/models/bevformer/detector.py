"""BEVFormer detector: image backbone + temporal BEV head (counterpart of
``omnihd_scenes_tpu/models/bevformer/detector.py``; reference
``bevformer/detectors/bevformer.py:20-356``).

- :meth:`BEVFormerDetector.forward_stream`: one frame per call, the
  previous BEV carried by the caller (the streaming eval runner or
  ``serve/predictor.py:StreamPredictor``), which also turns the absolute
  can_bus into deltas (reference ``bevformer.py:270-306``);
- :meth:`BEVFormerDetector.forward`: the frame queue, its first Q-1
  frames encoded history-only without gradients (``obtain_history_bev``,
  ``:183-205``), the last frame through the whole head.

B independent streams run as one batch (the JAX package writes one
sample and vmaps); ``has_prev`` is a bool tensor per stream, applied with
``torch.where``, so no device value is read back to the host.  The
backbone's ``stage_with_dcn`` stages run DCNv2 (R101-DCN).

:func:`grid_mask` is the GridMask augmentation (reference
``models/utils/grid_mask.py``), its random draws
(:func:`grid_mask_draws`, from a ``torch.Generator``) apart from the
mask.  As in the JAX package, which defines it and never calls it, no
training step applies it (ROADMAP queue 3 item 15, mirrored).  The JAX
package's TPU memory estimates (``estimate_stream_batch_hbm_gb``,
``check_stream_batch_fits``, calibrated on a TPU) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import BEVFormerConfig
from omnihd_scenes_tpu_torch.models.bevformer.attention import (
    reset_offset_linears, sca_cap_overflow)
from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
    get_reference_points_3d, point_sampling)
from omnihd_scenes_tpu_torch.models.bevformer.head import BEVFormerHead
from omnihd_scenes_tpu_torch.models.fpnc import FPN
from omnihd_scenes_tpu_torch.models.resnet import ResNet
from omnihd_scenes_tpu_torch.utils.timing import span


class GridMaskDraws(NamedTuple):
    """The random draws of one GridMask: the grid period ``d`` in [2,
    max_d), the offsets in [0, max_d) and whether the mask applies."""

    d: int
    off_x: int
    off_y: int
    apply: bool


def grid_mask_draws(h: int, w: int, generator: torch.Generator,
                    max_d: Optional[int] = None,
                    prob: float = 0.7) -> GridMaskDraws:
    """GridMask's draws for (h, w) images (the JAX package draws them
    from a ``jax.random`` key; the streams differ, the ranges do not)."""
    if max_d is None:
        max_d = max(min(h, w) // 2, 3)
    d, off_x, off_y = (int(torch.randint(lo, max_d, (), generator=generator))
                       for lo in (2, 0, 0))
    apply = bool(torch.rand((), generator=generator) < prob)
    return GridMaskDraws(d, off_x, off_y, apply)


def grid_mask(imgs: torch.Tensor, draws: GridMaskDraws,
              ratio: float = 0.5) -> torch.Tensor:
    """GridMask (reference ``models/utils/grid_mask.py``): the images
    (..., H, W, C) times a square grid of masked patches, the same for
    every view: a pixel is kept where its row or column lies at least
    ``max(int(d * ratio), 1)`` into its period."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    keep_len = max(int(draws.d * ratio), 1)
    dev = imgs.device
    ys = (torch.arange(h, device=dev) + draws.off_y) % draws.d
    xs = (torch.arange(w, device=dev) + draws.off_x) % draws.d
    mask = (ys[:, None] >= keep_len) | (xs[None, :] >= keep_len)
    if not draws.apply:
        mask = torch.ones_like(mask)
    return imgs * mask[..., None].to(imgs.dtype)


class BEVFormerDetector(nn.Module):
    """ResNet (frozen BN) + FPN + :class:`BEVFormerHead`."""

    def __init__(self, cfg: BEVFormerConfig = BEVFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = ResNet(cfg.resnet_depth, cfg.resnet_out_indices,
                                   frozen_bn=True,
                                   stage_with_dcn=cfg.stage_with_dcn)
        self.img_neck = FPN(self.img_backbone.out_channels, cfg.embed_dims)
        self.pts_bbox_head = BEVFormerHead(
            bev_h=cfg.bev_h, bev_w=cfg.bev_w, num_query=cfg.num_query,
            num_classes=cfg.num_classes, embed_dims=cfg.embed_dims,
            encoder_layers=cfg.encoder_layers,
            decoder_layers=cfg.decoder_layers, num_cams=cfg.num_cams,
            pc_range=cfg.pc_range, sca_query_cap=cfg.sca_query_cap)

    def extract_img_feat(self, imgs):
        """(B, N, H, W, 3) -> list of (B * N, C, h, w) pyramid levels
        (the span ``bevformer.backbone``)."""
        b, n = imgs.shape[:2]
        # NHWC images viewed as NCHW: channels_last memory, no copy.
        flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
        with span('bevformer.backbone'):
            return self.img_neck(self.img_backbone(flat))[:self.cfg.fpn_outs]

    def forward_stream(self, imgs, can_bus, lidar2img, prev_bev, has_prev):
        """One frame of B streams: imgs (B, N, H, W, 3); can_bus (B, 18)
        relative, f32; lidar2img (B, N, 4, 4) f32; prev_bev (B, nq, C);
        has_prev (B,) bool."""
        img_hw = tuple(imgs.shape[2:4])
        return self.pts_bbox_head(self.extract_img_feat(imgs), can_bus,
                                  lidar2img, img_hw, prev_bev=prev_bev,
                                  has_prev=has_prev)

    def forward(self, imgs_queue, can_bus_queue, lidar2img_queue,
                has_prev_queue):
        """The frame queue: imgs_queue (B, Q, N, H, W, 3); can_bus_queue
        (B, Q, 18) relative (the dataset's ``union2one``); lidar2img_queue
        (B, Q, N, 4, 4); has_prev_queue (B, Q) bool, false at scene
        boundaries.  Returns the head outputs of the last frame."""
        b, q = imgs_queue.shape[:2]
        img_hw = tuple(imgs_queue.shape[3:5])
        cfg = self.cfg
        dev = imgs_queue.device
        prev_bev = torch.zeros(b, cfg.bev_h * cfg.bev_w, cfg.embed_dims,
                               dtype=self.pts_bbox_head.bev_embedding.dtype,
                               device=dev)
        has_prev = torch.zeros(b, dtype=torch.bool, device=dev)
        has_prev_queue = has_prev_queue.to(device=dev, dtype=torch.bool)
        with torch.no_grad():              # history replay
            for i in range(q - 1):
                prev_bev = self.pts_bbox_head.get_bev(
                    self.extract_img_feat(imgs_queue[:, i]),
                    can_bus_queue[:, i], lidar2img_queue[:, i], img_hw,
                    prev_bev=prev_bev, has_prev=has_prev & has_prev_queue[:, i])
                has_prev = torch.ones_like(has_prev)
        return self.pts_bbox_head(
            self.extract_img_feat(imgs_queue[:, -1]), can_bus_queue[:, -1],
            lidar2img_queue[:, -1], img_hw, prev_bev=prev_bev,
            has_prev=has_prev & has_prev_queue[:, -1])


@torch.no_grad()
def init_bevformer(model: BEVFormerDetector,
                   generator: torch.Generator) -> BEVFormerDetector:
    """flax's initialisation of the BEVFormer-specific parameters, drawn
    from ``generator`` after :func:`weights.init_weights` has drawn the
    convs and linears: N(0, 1) BEV / query / camera / level embeddings,
    U[0, 1) row / col embeddings, identity LayerNorms, and the deformable
    attentions' zero offset and weight kernels with the grid-init offset
    bias."""
    head = model.pts_bbox_head
    tr = head.transformer
    for p in (head.bev_embedding, head.query_embedding, tr.cams_embeds,
              tr.level_embeds):
        p.copy_(torch.randn(p.shape, generator=generator))
    pe = head.positional_encoding
    for p in (pe.row_embed, pe.col_embed):
        p.copy_(torch.rand(p.shape, generator=generator))
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    return reset_offset_linears(model)


def sca_overflow_for_rig(cfg: BEVFormerConfig, lidar2img) -> int:
    """Serving preflight on the host: the hit queries one rig
    (``lidar2img`` (num_cam, 4, 4)) would drop under ``cfg.sca_query_cap``
    (0 when the cap is 1.0).  The static rebatching equals the
    reference's dynamic one only while no camera's hits exceed the cap;
    ``tools/test.py`` calls this for each distinct scene rig and warns
    on a nonzero count."""
    if cfg.sca_query_cap >= 1.0:
        return 0
    z_range = cfg.pc_range[5] - cfg.pc_range[2]
    ref_3d = torch.from_numpy(get_reference_points_3d(cfg.bev_h, cfg.bev_w,
                                                      4, z_range))
    l2i = torch.as_tensor(np.asarray(lidar2img, np.float32))[None]
    _, bev_mask = point_sampling(ref_3d, cfg.pc_range, l2i, cfg.img_hw)
    return int(sca_cap_overflow(bev_mask[0], cfg.sca_query_cap))
