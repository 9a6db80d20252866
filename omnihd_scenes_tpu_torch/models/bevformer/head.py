"""BEVFormerHead: learned BEV / object queries and per-layer branches
(counterpart of ``omnihd_scenes_tpu/models/bevformer/head.py``; reference
``bevformer/dense_heads/bevformer_head.py:17-685``):

- the learned BEV embedding (bev_h x bev_w) and ``num_query`` object
  query embeddings (pos | feat);
- the learned row / col positional encoding;
- per decoder layer a cls and a reg branch;
- reg output = offsets on the inverse-sigmoid references -> sigmoid ->
  rescaled to pc_range; the 10-dim code (cx, cy, w, l, cz, h, sin, cos,
  vx, vy) that ``models/bbox_coder.py`` decodes.

The Hungarian-matched loss (``bevformer_head_loss``) is in ``loss.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from omnihd_scenes_tpu_torch.models.bevformer.decoder import inverse_sigmoid
from omnihd_scenes_tpu_torch.models.bevformer.encoder import LN_EPS
from omnihd_scenes_tpu_torch.models.bevformer.transformer import (
    PerceptionTransformer)
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import at_least_f32


class LearnedPositionalEncoding(nn.Module):
    """Row / col learned embeddings -> (h * w, 2 * num_feats)."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 160,
                 col_num_embed: int = 240):
        super().__init__()
        self.row_embed = nn.Parameter(torch.zeros(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.zeros(col_num_embed, num_feats))

    def forward(self):
        h, f = self.row_embed.shape
        w = self.col_embed.shape[0]
        return torch.cat([self.col_embed[None].expand(h, w, f),
                          self.row_embed[:, None].expand(h, w, f)],
                         -1).reshape(h * w, 2 * f)


def _cls_branch(embed_dims: int, num_classes: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(embed_dims, embed_dims), nn.LayerNorm(embed_dims, LN_EPS),
        nn.ReLU(), nn.Linear(embed_dims, embed_dims),
        nn.LayerNorm(embed_dims, LN_EPS), nn.ReLU(),
        nn.Linear(embed_dims, num_classes))


def _reg_branch(embed_dims: int, code_size: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(embed_dims, embed_dims), nn.ReLU(),
        nn.Linear(embed_dims, embed_dims), nn.ReLU(),
        nn.Linear(embed_dims, code_size))


class BEVFormerHead(nn.Module):
    """DETR head over the temporal BEV, for B streams."""

    def __init__(self, bev_h: int = 160, bev_w: int = 240,
                 num_query: int = 900, num_classes: int = 4,
                 embed_dims: int = 256, encoder_layers: int = 3,
                 decoder_layers: int = 6, num_cams: int = 6,
                 pc_range: Sequence[float] = (-60, -40, -3.0, 60, 40, 5.0),
                 code_size: int = 10, sca_query_cap: float = 1.0):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.bev_embedding = nn.Parameter(
            torch.zeros(bev_h * bev_w, embed_dims))
        self.query_embedding = nn.Parameter(
            torch.zeros(num_query, 2 * embed_dims))
        self.positional_encoding = LearnedPositionalEncoding(
            embed_dims // 2, bev_h, bev_w)
        self.transformer = PerceptionTransformer(
            embed_dims=embed_dims, num_cams=num_cams,
            encoder_layers=encoder_layers, decoder_layers=decoder_layers,
            bev_h=bev_h, bev_w=bev_w, pc_range=pc_range,
            sca_query_cap=sca_query_cap)
        self.cls_branches = nn.ModuleList([
            _cls_branch(embed_dims, num_classes)
            for _ in range(decoder_layers)])
        self.reg_branches = nn.ModuleList([
            _reg_branch(embed_dims, code_size)
            for _ in range(decoder_layers)])

    def _reg(self, lvl, x):
        return self.reg_branches[lvl](x)

    def get_bev(self, mlvl_feats, can_bus, lidar2img, img_hw, prev_bev=None,
                has_prev=None):
        """The encoder alone (history replay): (B, bev_h * bev_w, C)."""
        return self.transformer.get_bev_features(
            mlvl_feats, self.bev_embedding, self.positional_encoding(),
            can_bus, lidar2img, img_hw, prev_bev=prev_bev, has_prev=has_prev)

    def forward(self, mlvl_feats, can_bus, lidar2img, img_hw, prev_bev=None,
                has_prev=None):
        """-> {'bev_embed' (B, nq_bev, C), 'all_cls_scores' (B, L, nq,
        num_classes), 'all_bbox_preds' (B, L, nq, 10)}; the scores and
        boxes in at least f32."""
        bev_embed, hs, refs = self.transformer(
            mlvl_feats, self.bev_embedding, self.query_embedding,
            self.positional_encoding(), can_bus, lidar2img, img_hw,
            self._reg, prev_bev=prev_bev, has_prev=has_prev)
        pc = self.pc_range
        all_cls, all_coords = [], []
        for lvl in range(hs.shape[1]):
            ref = inverse_sigmoid(refs[:, lvl])
            all_cls.append(at_least_f32(self.cls_branches[lvl](hs[:, lvl])))
            tmp = at_least_f32(self.reg_branches[lvl](hs[:, lvl]))
            xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
            all_coords.append(torch.cat([
                xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                xy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                tmp[..., 2:4],
                z * (pc[5] - pc[2]) + pc[2],
                tmp[..., 5:10]], -1))
        return {'bev_embed': bev_embed,
                'all_cls_scores': torch.stack(all_cls, 1),
                'all_bbox_preds': torch.stack(all_coords, 1)}
