"""DETR3D-style decoder with iterative box refinement (counterpart of
``omnihd_scenes_tpu/models/bevformer/decoder.py``; reference
``bevformer/modules/decoder.py:53-135``): each layer runs multi-head
self-attention and :class:`CustomMSDeformableAttention` over the
flattened BEV; then the layer's reg branch moves the xy / z references in
inverse-sigmoid space, detached between layers.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from omnihd_scenes_tpu_torch.models.bevformer.attention import (
    NUM_HEADS, CustomMSDeformableAttention, MultiheadAttention)
from omnihd_scenes_tpu_torch.models.bevformer.encoder import FFN, LN_EPS
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import at_least_f32


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class DecoderLayer(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS,
                 feedforward_channels: int = 512, num_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dims, num_heads)
        self.norm1 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.cross_attn = CustomMSDeformableAttention(embed_dims, num_heads,
                                                      1, num_points)
        self.norm2 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self.norm3 = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, query, query_pos, bev_value, reference_points,
                bev_spatial_shapes):
        x = self.norm1(self.self_attn(query, query_pos))
        x = self.norm2(self.cross_attn(x, bev_value, reference_points,
                                       bev_spatial_shapes,
                                       query_pos=query_pos))
        return self.norm3(self.ffn(x))


class DetectionTransformerDecoder(nn.Module):
    """``num_layers`` decoder layers with per-layer reference refinement.

    ``reg_branch_fn(layer_idx, features)`` gives the 10-dim code used for
    the refinement (dims 0:2 xy, 4:5 z) and for the outputs."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = NUM_HEADS, feedforward_channels: int = 512):
        super().__init__()
        self.layers = nn.ModuleList([
            DecoderLayer(embed_dims, num_heads, feedforward_channels)
            for _ in range(num_layers)])

    def forward(self, query, query_pos, bev_value, reference_points,
                bev_spatial_shapes, reg_branch_fn: Callable):
        """query / query_pos (B, nq, C); bev_value (B, len, C);
        reference_points (B, nq, 3) in [0, 1], f32.  Returns the layers'
        outputs (B, L, nq, C) and the references into each layer (B, L,
        nq, 3)."""
        outputs, refs = [], []
        output = query
        for i, layer in enumerate(self.layers):
            refs.append(reference_points)
            output = layer(output, query_pos, bev_value,
                           reference_points[:, :, None, :2],
                           bev_spatial_shapes)
            tmp = at_least_f32(reg_branch_fn(i, output))
            reference_points = torch.cat([
                torch.sigmoid(tmp[..., 0:2]
                              + inverse_sigmoid(reference_points[..., 0:2])),
                torch.sigmoid(tmp[..., 4:5]
                              + inverse_sigmoid(reference_points[..., 2:3])),
            ], -1).detach()
            outputs.append(output)
        return torch.stack(outputs, 1), torch.stack(refs, 1)
