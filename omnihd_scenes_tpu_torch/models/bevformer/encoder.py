"""BEVFormer encoder (counterpart of
``omnihd_scenes_tpu/models/bevformer/encoder.py``): reference points,
camera projection, layers.

- 3D pillar reference points (``num_points_in_pillar`` z-anchors at
  pillar centres, normalised) and 2D BEV reference points (reference
  ``encoder.py:47-89``);
- :func:`point_sampling`: the references through each camera's
  ``lidar2img`` to normalised UV and a validity mask, in f32 (``:89-151``);
- per layer TSA -> LN -> SCA -> LN -> FFN -> LN (``:282-284``);
- the TSA queue stacks [shifted prev refs, current refs]; at a scene
  boundary (``has_prev`` false for that stream) both slots are the
  current BEV with unshifted references (``:203-211``);
- :class:`MMBEVFormerLayer`, the multi-modal layer (reference
  ``MM_BEVFormerLayer``, ``encoder.py:415-592``): the camera BEV after SCA
  fused with a LiDAR / radar BEV through sigmoid gates.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.bevformer.attention import (
    NUM_HEADS, SpatialCrossAttention, TemporalSelfAttention)

# flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


def get_reference_points_3d(bev_h: int, bev_w: int, num_z: int,
                            z_range: float) -> np.ndarray:
    """(num_z, bev_h * bev_w, 3) normalised pillar reference points."""
    zs = np.linspace(0.5, z_range - 0.5, num_z) / z_range
    xs = np.linspace(0.5, bev_w - 0.5, bev_w) / bev_w
    ys = np.linspace(0.5, bev_h - 0.5, bev_h) / bev_h
    ref = np.zeros((num_z, bev_h, bev_w, 3), np.float32)
    ref[..., 0] = xs[None, None, :]
    ref[..., 1] = ys[None, :, None]
    ref[..., 2] = zs[:, None, None]
    return ref.reshape(num_z, bev_h * bev_w, 3)


def get_reference_points_2d(bev_h: int, bev_w: int) -> np.ndarray:
    """(bev_h * bev_w, 1, 2) normalised BEV plane reference points."""
    ys, xs = np.meshgrid(np.linspace(0.5, bev_h - 0.5, bev_h) / bev_h,
                         np.linspace(0.5, bev_w - 0.5, bev_w) / bev_w,
                         indexing='ij')
    return np.stack([xs.reshape(-1), ys.reshape(-1)],
                    -1).astype(np.float32)[:, None, :]


def point_sampling(ref_3d: torch.Tensor, pc_range: Sequence[float],
                   lidar2img: torch.Tensor, img_hw: Tuple[int, int]):
    """Project the pillar references into every camera, in f32.

    ref_3d (num_z, nq, 3) normalised; lidar2img (B, num_cam, 4, 4); img_hw
    the input image (H, W).  Returns reference_points_cam (B, num_cam, nq,
    num_z, 2) normalised UV and bev_mask (B, num_cam, nq, num_z) bool.
    """
    ref = torch.stack([
        ref_3d[..., 0] * (pc_range[3] - pc_range[0]) + pc_range[0],
        ref_3d[..., 1] * (pc_range[4] - pc_range[1]) + pc_range[1],
        ref_3d[..., 2] * (pc_range[5] - pc_range[2]) + pc_range[2],
        torch.ones_like(ref_3d[..., 0])], -1)               # (z, nq, 4)
    cam = torch.einsum('bnij,zqj->bnzqi', lidar2img.float(), ref)
    eps = 1e-5
    mask = cam[..., 2] > eps
    uv = cam[..., :2] / cam[..., 2:3].clamp(min=eps)
    # The jitted JAX package divides by the image size as a multiply by
    # the f32 reciprocal.
    u = uv[..., 0] * (1.0 / img_hw[1])
    v = uv[..., 1] * (1.0 / img_hw[0])
    mask = mask & (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    return (torch.stack([u, v], -1).transpose(2, 3),
            mask.transpose(2, 3))


class FFN(nn.Module):
    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x))) + x


class BEVFormerLayer(nn.Module):
    """TSA -> LN -> SCA -> LN -> FFN -> LN."""

    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS,
                 feedforward_channels: int = 512, tsa_points: int = 4,
                 sca_points: int = 8, num_cams: int = 6,
                 sca_query_cap: float = 1.0):
        super().__init__()
        self.tsa = TemporalSelfAttention(embed_dims, num_heads, 1, tsa_points)
        self.norm1 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.sca = SpatialCrossAttention(embed_dims, num_cams, num_heads, 1,
                                         sca_points, query_cap=sca_query_cap)
        self.norm2 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self.norm3 = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, bev_query, bev_pos, value_queue, ref_2d_queue,
                cam_values, reference_points_cam, bev_mask,
                bev_spatial_shapes, cam_spatial_shapes):
        x = self.norm1(self.tsa(bev_query, value_queue, ref_2d_queue,
                                bev_spatial_shapes, query_pos=bev_pos))
        x = self.norm2(self.sca(x, cam_values, reference_points_cam,
                                bev_mask, cam_spatial_shapes))
        return self.norm3(self.ffn(x))


class MMBEVFormerLayer(BEVFormerLayer):
    """TSA -> LN -> SCA -> gated fusion -> LN -> FFN -> LN: after the
    spatial cross-attention the camera BEV ``x`` becomes ``x *
    sigmoid(fusion_w_cam) + lidar_proj(lidar_bev) * sigmoid(fusion_w_pts)``
    (both gates (1,) parameters, zero at initialisation); ``lidar_bev``
    (B, nq, ``lidar_channels``) is the LiDAR / radar BEV, one row a
    query."""

    def __init__(self, lidar_channels: int, embed_dims: int = 256,
                 num_heads: int = NUM_HEADS, feedforward_channels: int = 512,
                 tsa_points: int = 4, sca_points: int = 8, num_cams: int = 6,
                 sca_query_cap: float = 1.0):
        super().__init__(embed_dims, num_heads, feedforward_channels,
                         tsa_points, sca_points, num_cams, sca_query_cap)
        self.fusion_w_cam = nn.Parameter(torch.zeros(1))
        self.fusion_w_pts = nn.Parameter(torch.zeros(1))
        self.lidar_proj = nn.Linear(lidar_channels, embed_dims)

    def forward(self, bev_query, bev_pos, value_queue, ref_2d_queue,
                cam_values, reference_points_cam, bev_mask,
                bev_spatial_shapes, cam_spatial_shapes, lidar_bev):
        x = self.norm1(self.tsa(bev_query, value_queue, ref_2d_queue,
                                bev_spatial_shapes, query_pos=bev_pos))
        x = self.sca(x, cam_values, reference_points_cam, bev_mask,
                     cam_spatial_shapes)
        x = (x * torch.sigmoid(self.fusion_w_cam)
             + self.lidar_proj(lidar_bev) * torch.sigmoid(self.fusion_w_pts))
        return self.norm3(self.ffn(self.norm2(x)))


class BEVFormerEncoder(nn.Module):
    """Stack of BEVFormerLayers producing the BEV embedding."""

    def __init__(self, num_layers: int = 3, embed_dims: int = 256,
                 num_heads: int = NUM_HEADS, feedforward_channels: int = 512,
                 bev_h: int = 160, bev_w: int = 240,
                 num_points_in_pillar: int = 4,
                 pc_range: Sequence[float] = (-60, -40, -3.0, 60, 40, 5.0),
                 num_cams: int = 6, sca_query_cap: float = 1.0):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        z_range = self.pc_range[5] - self.pc_range[2]
        self._ref_np = (get_reference_points_3d(bev_h, bev_w,
                                                num_points_in_pillar, z_range),
                        get_reference_points_2d(bev_h, bev_w))
        # f32 copies per device, outside the module's tensors, so that a
        # cast of the model to bf16 leaves them f32.
        self._refs = {}
        self.layers = nn.ModuleList([
            BEVFormerLayer(embed_dims, num_heads, feedforward_channels,
                           num_cams=num_cams, sca_query_cap=sca_query_cap)
            for _ in range(num_layers)])

    def forward(self, bev_query, bev_pos, cam_values, lidar2img, img_hw,
                cam_spatial_shapes, prev_bev=None, shift=None,
                has_prev=None):
        """bev_query (B, nq, C); bev_pos (nq, C); cam_values (B, num_cam,
        len, C); lidar2img (B, num_cam, 4, 4); prev_bev (B, nq, C) or None;
        shift (B, 2) normalised BEV shift; has_prev (B,) bool or None (all
        true when prev_bev is given)."""
        b = bev_query.shape[0]
        dev = bev_query.device
        if dev not in self._refs:
            with torch.inference_mode(False):   # serving and training share it
                self._refs[dev] = tuple(torch.from_numpy(r).to(dev)
                                        for r in self._ref_np)
        ref_3d, ref_2d = self._refs[dev]
        reference_points_cam, bev_mask = point_sampling(
            ref_3d, self.pc_range, lidar2img, img_hw)
        if shift is None:
            shift = torch.zeros(b, 2, device=dev)
        if prev_bev is None:
            use_prev = torch.zeros(b, dtype=torch.bool, device=dev)
            prev_bev = torch.zeros_like(bev_query)
        elif has_prev is None:
            use_prev = torch.ones(b, dtype=torch.bool, device=dev)
        else:
            use_prev = has_prev.to(device=dev, dtype=torch.bool)
        ref_2d = ref_2d.expand(b, *ref_2d.shape)
        ref_prev = torch.where(use_prev[:, None, None, None],
                               ref_2d + shift.float()[:, None, None, :],
                               ref_2d)
        ref_queue = torch.stack([ref_prev, ref_2d], 1)   # (B, 2, nq, 1, 2)
        bev_shapes = ((self.bev_h, self.bev_w),)
        output = bev_query
        for layer in self.layers:
            prev_val = torch.where(use_prev[:, None, None], prev_bev, output)
            output = layer(output, bev_pos, torch.stack([prev_val, output], 1),
                           ref_queue, cam_values, reference_points_cam,
                           bev_mask, bev_shapes, cam_spatial_shapes)
        return output
