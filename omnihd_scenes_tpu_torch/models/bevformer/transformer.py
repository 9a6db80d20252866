"""PerceptionTransformer: the ego-motion-aware BEV encoder and
decoder (counterpart of ``omnihd_scenes_tpu/models/bevformer/
transformer.py``; reference ``bevformer/modules/transformer.py:26-307``):

- the ego-motion BEV shift from the can_bus deltas, grid-normalised
  (``:127-151``);
- the previous BEV rotated by the can_bus patch angle around the grid
  centre (``:152-173``; torchvision's ``rotate`` as an inverse bilinear
  resample);
- the can_bus MLP added to the BEV queries, the camera and level embeds
  (``:175-197``);
- the decoder's query split (pos, feat) and its linear -> sigmoid 3D
  reference points (``:281-307``).

The encoder and the decoder are the spans ``bevformer.encoder`` and
``bevformer.decoder`` (``utils/timing.py``).

The jitted JAX package divides by constants as multiplies by their f32
reciprocals; so does the port.  Like the JAX package (and unlike
upstream BEVFormer, which converts it with ``/ pi * 180``),
:func:`compute_bev_shift` reads ``can_bus[-2]`` as degrees although the
temporal dataset writes the patch angle there in radians (ROADMAP queue
3 item 12: mirrored).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from omnihd_scenes_tpu_torch.models.bevformer.decoder import (
    DetectionTransformerDecoder)
from omnihd_scenes_tpu_torch.models.bevformer.encoder import BEVFormerEncoder
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (at_least_f32,
                                                    bilinear_sample)
from omnihd_scenes_tpu_torch.utils.timing import span


def compute_bev_shift(can_bus: torch.Tensor,
                      grid_length_xy: Tuple[float, float],
                      bev_hw: Tuple[int, int],
                      use_shift: bool = True) -> torch.Tensor:
    """Normalised (shift_x, shift_y) (B, 2) from relative can_bus (B, 18):
    ``can_bus[:, 0:2]`` = delta xy, ``can_bus[:, -2]`` read as degrees."""
    can_bus = can_bus.float()
    delta_x, delta_y = can_bus[:, 0], can_bus[:, 1]
    ego_angle = can_bus[:, -2]
    translation_length = torch.sqrt(delta_x ** 2 + delta_y ** 2)
    translation_angle = torch.atan2(delta_y, delta_x) * (1.0 / math.pi) \
        * 180.0
    bev_angle = (translation_angle - ego_angle) * (1.0 / 180.0) * math.pi
    shift_y = translation_length * torch.sin(bev_angle) \
        * (1.0 / grid_length_xy[1]) * (1.0 / bev_hw[0])
    shift_x = translation_length * torch.cos(bev_angle) \
        * (1.0 / grid_length_xy[0]) * (1.0 / bev_hw[1])
    scale = 1.0 if use_shift else 0.0
    return torch.stack([shift_x * scale, shift_y * scale], -1)


def rotate_bev(bev: torch.Tensor, angle_deg: torch.Tensor,
               bev_hw: Tuple[int, int],
               center: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Rotate flattened BEV maps (B, nq, C) by ``angle_deg`` (B,) around
    ``center`` (pixel coords, default the grid midpoint): each output cell
    samples its inverse-rotated position bilinearly (zero outside)."""
    h, w = bev_hw
    b, _, c = bev.shape
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    ang = (-angle_deg.float() * math.pi) * (1.0 / 180.0)  # inverse mapping
    cos, sin = ang.cos()[:, None, None], ang.sin()[:, None, None]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=bev.device),
        torch.arange(w, dtype=torch.float32, device=bev.device),
        indexing='ij')
    x0, y0 = xs - center[0], ys - center[1]
    src_x = cos * x0 - sin * y0 + center[0]
    src_y = sin * x0 + cos * y0 + center[1]
    loc = torch.stack([src_x, src_y], -1).reshape(b, h * w, 2)
    out = bilinear_sample(bev.reshape(b, h, w, c), loc)
    return out.to(bev.dtype)


class PerceptionTransformer(nn.Module):
    """Encoder + decoder orchestration."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_feature_levels: int = 1, encoder_layers: int = 3,
                 decoder_layers: int = 6, bev_h: int = 160, bev_w: int = 240,
                 pc_range: Sequence[float] = (-60, -40, -3.0, 60, 40, 5.0),
                 num_points_in_pillar: int = 4, use_shift: bool = True,
                 use_can_bus: bool = True, use_cams_embeds: bool = True,
                 rotate_prev_bev: bool = True, sca_query_cap: float = 1.0):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.use_shift, self.use_can_bus = use_shift, use_can_bus
        self.use_cams_embeds = use_cams_embeds
        self.rotate_prev_bev = rotate_prev_bev
        self.level_embeds = nn.Parameter(
            torch.zeros(num_feature_levels, embed_dims))
        self.cams_embeds = nn.Parameter(torch.zeros(num_cams, embed_dims))
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(18, embed_dims // 2), nn.ReLU(),
            nn.Linear(embed_dims // 2, embed_dims), nn.ReLU())
        self.encoder = BEVFormerEncoder(
            num_layers=encoder_layers, embed_dims=embed_dims, bev_h=bev_h,
            bev_w=bev_w, num_points_in_pillar=num_points_in_pillar,
            pc_range=pc_range, num_cams=num_cams,
            sca_query_cap=sca_query_cap)
        self.decoder = DetectionTransformerDecoder(
            num_layers=decoder_layers, embed_dims=embed_dims)
        self.reference_points_fc = nn.Linear(embed_dims, 3)

    def _flatten_feats(self, mlvl_feats, batch: int):
        """[(B * num_cam, C, H, W)] -> (B, num_cam, sum HW, C) + shapes."""
        flat, shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            bn, c, h, w = feat.shape
            f = feat.reshape(batch, bn // batch, c, h * w).transpose(2, 3)
            if self.use_cams_embeds:
                f = f + self.cams_embeds[None, :, None, :]
            flat.append(f + self.level_embeds[lvl])
            shapes.append((h, w))
        return torch.cat(flat, 2), tuple(shapes)

    def get_bev_features(self, mlvl_feats, bev_queries, bev_pos, can_bus,
                         lidar2img, img_hw, prev_bev=None, has_prev=None):
        """BEV encoding of B streams; bev_queries (nq, C) learned embed,
        can_bus (B, 18) f32 -> (B, nq, C)."""
        b = can_bus.shape[0]
        grid_length = ((self.pc_range[4] - self.pc_range[1]) / self.bev_h,
                       (self.pc_range[3] - self.pc_range[0]) / self.bev_w)
        shift = compute_bev_shift(can_bus, (grid_length[1], grid_length[0]),
                                  (self.bev_h, self.bev_w), self.use_shift)
        if prev_bev is not None and self.rotate_prev_bev:
            prev_bev = rotate_bev(prev_bev, can_bus[:, -1],
                                  (self.bev_h, self.bev_w))
        queries = bev_queries.expand(b, *bev_queries.shape)
        if self.use_can_bus:
            queries = queries + self.can_bus_mlp(
                can_bus.to(bev_queries.dtype))[:, None, :]
        cam_values, cam_shapes = self._flatten_feats(mlvl_feats, b)
        with span('bevformer.encoder'):
            return self.encoder(queries, bev_pos, cam_values, lidar2img,
                                img_hw, cam_shapes, prev_bev=prev_bev,
                                shift=shift, has_prev=has_prev)

    def forward(self, mlvl_feats, bev_queries, object_query_embed, bev_pos,
                can_bus, lidar2img, img_hw, reg_branch_fn, prev_bev=None,
                has_prev=None):
        """Encode + decode; returns (bev_embed, hs, refs)."""
        bev_embed = self.get_bev_features(
            mlvl_feats, bev_queries, bev_pos, can_bus, lidar2img, img_hw,
            prev_bev=prev_bev, has_prev=has_prev)
        b = bev_embed.shape[0]
        with span('bevformer.decoder'):
            query_pos, query = object_query_embed.chunk(2, -1)
            reference_points = torch.sigmoid(
                at_least_f32(self.reference_points_fc(query_pos)))
            hs, refs = self.decoder(
                query.expand(b, *query.shape),
                query_pos.expand(b, *query.shape), bev_embed,
                reference_points.expand(b, *reference_points.shape),
                ((self.bev_h, self.bev_w),), reg_branch_fn)
        return bev_embed, hs, refs
