"""BEVFormer attention modules (counterpart of
``omnihd_scenes_tpu/models/bevformer/attention.py``).

- :class:`TemporalSelfAttention` (reference ``temporal_self_attention.py:
  26-278``): deformable self-attention over the (prev, current) BEV
  queue; ``concat(prev_value, query + pos)`` drives the offsets and
  weights, and the two queue slots' outputs are averaged.
- :class:`SpatialCrossAttention` + :class:`MSDeformableAttention3D`
  (``spatial_cross_attention.py:31-404``): per-camera deformable sampling
  at the projected pillar reference points, masked dense or rebatched to
  a static per-camera query capacity.
- :class:`CustomMSDeformableAttention` (``decoder.py:138-347``): the DETR
  decoder's single-level deformable attention over the flattened BEV.
- :class:`MultiheadAttention`: the decoder's self-attention.

Every module takes a leading batch dimension (B independent streams).
The ``Linear`` names are the flax ``Dense`` names, so ``weights.py`` maps
them one to one.  Sampling locations are computed in f32 whatever the
activations' dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
    at_least_f32, multi_scale_deformable_attn)

Shapes = Sequence[Tuple[int, int]]
# The head count of every BEVFormer attention (the JAX package's modules
# fix it too); ``weights.py`` splits the flax per-head kernels by it.
NUM_HEADS = 8


def _grid_init_bias(num_heads: int, num_levels_queue: int,
                    num_points: int) -> np.ndarray:
    """Deformable-DETR sampling-offset bias init (rotated unit rays)."""
    thetas = np.arange(num_heads, dtype=np.float32) \
        * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :],
                   (1, num_levels_queue, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def reset_offset_linears(model: nn.Module) -> nn.Module:
    """Zero kernels, grid-init offset biases and zero weight biases on
    every deformable attention of ``model`` (flax's init of them)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (TemporalSelfAttention, MSDeformableAttention3D,
                              CustomMSDeformableAttention)):
                m.sampling_offsets.weight.zero_()
                m.sampling_offsets.bias.copy_(
                    torch.from_numpy(m.offset_bias()))
                m.attention_weights.weight.zero_()
                m.attention_weights.bias.zero_()
    return model


def _normalizer(spatial_shapes: Tuple[Tuple[int, int], ...],
                device: torch.device) -> torch.Tensor:
    """(L, 2) reciprocal (W, H) per level: the jitted JAX package divides
    the offsets by (W, H) as a multiply by the f32 reciprocal.  Made once
    per device: a copy from host memory would make the host wait for the
    card at every call.  Made outside inference mode, so that a training
    step may use it after a served frame made it.  While a program is
    traced (``torch.export``) it is a constant of the trace, made anew and
    not kept: a traced tensor holds no data."""
    if torch.compiler.is_compiling():
        return _normalizer_table(spatial_shapes, device)
    return _kept_normalizer(spatial_shapes, device)


def _normalizer_table(spatial_shapes, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor([[1.0 / w, 1.0 / h] for h, w in spatial_shapes],
                            dtype=torch.float32, device=device)


_kept_normalizer = functools.lru_cache(maxsize=None)(_normalizer_table)
_normalizer.cache_clear = _kept_normalizer.cache_clear


def _softmax_weights(weights, shape):
    """Softmax over levels x points per head, in the weights' dtype."""
    b, nq, nh, nl, np_ = shape
    return F.softmax(weights.reshape(b, nq, nh, nl * np_), -1).reshape(shape)


class TemporalSelfAttention(nn.Module):
    """Deformable self-attention over the (prev, current) BEV queue."""

    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_bev_queue = num_bev_queue
        npts = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(2 * embed_dims,
                                          num_bev_queue * npts * 2)
        self.attention_weights = nn.Linear(2 * embed_dims,
                                           num_bev_queue * npts)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def offset_bias(self) -> np.ndarray:
        return np.tile(_grid_init_bias(self.num_heads, self.num_levels,
                                       self.num_points), self.num_bev_queue)

    def forward(self, query, value, reference_points, spatial_shapes: Shapes,
                query_pos=None):
        """query (B, nq, C); value (B, queue, nq, C) [prev, cur];
        reference_points (B, queue, nq, levels, 2) f32 -> (B, nq, C)."""
        b, nq, c = query.shape
        identity = query
        if query_pos is not None:
            query = query + query_pos
        nh, nl, np_, nque = (self.num_heads, self.num_levels,
                             self.num_points, self.num_bev_queue)
        q2 = torch.cat([value[:, 0], query], -1)            # (B, nq, 2C)
        offsets = at_least_f32(self.sampling_offsets(q2)).reshape(
            b, nq, nh, nque, nl, np_, 2)
        weights = self.attention_weights(q2).reshape(b, nq, nh, nque,
                                                     nl * np_)
        weights = F.softmax(weights, -1).reshape(b, nq, nh, nque, nl, np_)
        # queue-major, the queue folded into the batch: (B*queue, ...).
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            b * nque, nq, nh, nl, np_, 2)
        weights = weights.permute(0, 3, 1, 2, 4, 5).reshape(
            b * nque, nq, nh, nl, np_)
        v = self.value_proj(value).reshape(b * nque, -1, nh, c // nh)
        ref = reference_points.reshape(b * nque, nq, nl, 2)
        loc = ref[:, :, None, :, None, :] + offsets * _normalizer(
            tuple(spatial_shapes), query.device)[None, None, None, :, None, :]
        out = multi_scale_deformable_attn(v, spatial_shapes, loc, weights)
        out = out.reshape(b, nque, nq, c).mean(1)            # queue average
        return self.output_proj(out) + identity


class MSDeformableAttention3D(nn.Module):
    """Inner deformable attention of SCA: offsets distributed over the
    z-anchor reference points (num_points // num_z per anchor)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS,
                 num_levels: int = 1, num_points: int = 8):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        npts = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, npts * 2)
        self.attention_weights = nn.Linear(embed_dims, npts)
        self.value_proj = nn.Linear(embed_dims, embed_dims)

    def offset_bias(self) -> np.ndarray:
        return _grid_init_bias(self.num_heads, self.num_levels,
                               self.num_points)

    def forward(self, query, value, reference_points, spatial_shapes: Shapes):
        """query (B, nq, C); value (B, len, C); reference_points (B, nq,
        num_z, 2) f32 normalised -> (B, nq, C)."""
        b, nq, c = query.shape
        nh, nl, np_ = self.num_heads, self.num_levels, self.num_points
        offsets = at_least_f32(self.sampling_offsets(query)).reshape(
            b, nq, nh, nl, np_, 2)
        weights = _softmax_weights(self.attention_weights(query),
                                   (b, nq, nh, nl, np_))
        v = self.value_proj(value).reshape(b, -1, nh, c // nh)
        num_z = reference_points.shape[2]
        off = (offsets * _normalizer(tuple(spatial_shapes), query.device)[
            None, None, None, :, None, :]).reshape(
                b, nq, nh, nl, np_ // num_z, num_z, 2)
        loc = (reference_points[:, :, None, None, None, :, :] + off).reshape(
            b, nq, nh, nl, np_, 2)
        return multi_scale_deformable_attn(v, spatial_shapes, loc, weights)


def sca_cap_overflow(bev_mask: torch.Tensor, query_cap: float) -> torch.Tensor:
    """Hit queries dropped by a static SCA ``query_cap``: bev_mask (...,
    num_cam, nq, num_z) bool -> (...) int64, the count over cameras of
    queries that project into a camera beyond its capacity.  0 means the
    capped rebatching equals the dense formulation for this geometry."""
    hit = bev_mask.any(-1)
    nq = hit.shape[-1]
    k = min(nq, int(np.ceil(nq * query_cap)))
    return (hit.sum(-1) - k).clamp(min=0).sum(-1)


class SpatialCrossAttention(nn.Module):
    """BEV queries attend to camera features at projected pillar refs.

    ``query_cap >= 1``: masked dense -- the deformable attention runs for
    every (camera, query) pair and the camera's hit mask zeroes the
    others.  ``query_cap < 1``: static-capacity rebatching (the
    reference's max_len rebatching, ``spatial_cross_attention.py:
    136-154``) -- each camera attends only to its top ``ceil(nq *
    query_cap)`` queries by priority ``hit * (nq + 1) - index`` (hits
    first, ascending index; every priority distinct, so ``topk`` has no
    tie to order), whose rows are written back into a zeroed (B, nq, C)
    buffer.  Either way the cameras are summed in camera order (no
    atomics) and divided by the clipped hit count.  The capped form equals
    the dense one while no camera's hits exceed the cap
    (:func:`sca_cap_overflow`).
    """

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_heads: int = NUM_HEADS, num_levels: int = 1,
                 num_points: int = 8, query_cap: float = 1.0):
        super().__init__()
        self.num_cams, self.query_cap = num_cams, query_cap
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, cam_values, reference_points_cam, bev_mask,
                spatial_shapes: Shapes):
        """query (B, nq, C); cam_values (B, num_cam, len, C);
        reference_points_cam (B, num_cam, nq, num_z, 2);
        bev_mask (B, num_cam, nq, num_z) bool."""
        identity = query
        b, nq, c = query.shape
        hit = bev_mask.any(-1)                              # (B, cam, nq)
        inner = self.deformable_attention
        slots = torch.zeros_like(query)
        if self.query_cap < 1.0:
            k = min(nq, int(np.ceil(nq * self.query_cap)))
            prio = hit.long() * (nq + 1) - torch.arange(nq, device=hit.device)
            idx = prio.topk(k, dim=-1).indices              # (B, cam, k)
            valid = torch.gather(hit, 2, idx)
            for cam in range(self.num_cams):
                ii = idx[:, cam]
                q_sel = torch.gather(query, 1, ii[..., None].expand(-1, -1, c))
                r = reference_points_cam[:, cam]
                r_sel = torch.gather(r, 1, ii[:, :, None, None].expand(
                    -1, -1, *r.shape[2:]))
                out = inner(q_sel, cam_values[:, cam], r_sel, spatial_shapes)
                rows = torch.zeros_like(query).scatter_(
                    1, ii[..., None].expand(-1, -1, c),
                    out * valid[:, cam, :, None])
                slots = slots + rows
        else:
            for cam in range(self.num_cams):
                out = inner(query, cam_values[:, cam],
                            reference_points_cam[:, cam], spatial_shapes)
                slots = slots + out * hit[:, cam, :, None]
        count = hit.sum(1).clamp(min=1)
        slots = slots / count[..., None]
        return self.output_proj(slots) + identity


class CustomMSDeformableAttention(nn.Module):
    """Single-level deformable attention over the flattened BEV (the DETR
    decoder's cross-attention)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS,
                 num_levels: int = 1, num_points: int = 4):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        npts = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, npts * 2)
        self.attention_weights = nn.Linear(embed_dims, npts)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def offset_bias(self) -> np.ndarray:
        return _grid_init_bias(self.num_heads, self.num_levels,
                               self.num_points)

    def forward(self, query, value, reference_points, spatial_shapes: Shapes,
                query_pos=None):
        """query (B, nq, C); value (B, len, C); reference_points (B, nq,
        levels, 2) f32 -> (B, nq, C)."""
        b, nq, c = query.shape
        identity = query
        if query_pos is not None:
            query = query + query_pos
        nh, nl, np_ = self.num_heads, self.num_levels, self.num_points
        offsets = at_least_f32(self.sampling_offsets(query)).reshape(
            b, nq, nh, nl, np_, 2)
        weights = _softmax_weights(self.attention_weights(query),
                                   (b, nq, nh, nl, np_))
        v = self.value_proj(value).reshape(b, -1, nh, c // nh)
        loc = reference_points[:, :, None, :, None, :] + offsets \
            * _normalizer(tuple(spatial_shapes), query.device)[
                None, None, None, :, None, :]
        out = multi_scale_deformable_attn(v, spatial_shapes, loc, weights)
        return self.output_proj(out) + identity


class MultiheadAttention(nn.Module):
    """Multi-head self-attention with a residual: q = k = query + pos and
    v = query (flax ``MultiHeadDotProductAttention`` with ``qkv_features
    = embed_dims``; its (C, heads, head_dim) kernels are ``weights.py``'s
    (heads * head_dim, C) ``Linear`` weights).

    The attention is written out as flax writes it: the scores as a
    batched matmul in the activations' dtype, the scale and the softmax in
    at least f32, the weights back in that dtype for the product with v.  Not
    ``F.scaled_dot_product_attention``: on the card it picks its backend
    per process (cuDNN's attention in a fresh process, another after some
    calls), whose bf16 results differ in the last bit, so a bf16 bundle
    run in its own process drifted from the live forward from the first
    decoder layer on (ROADMAP queue 3 item 22)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = NUM_HEADS):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(embed_dims, embed_dims)
        self.key = nn.Linear(embed_dims, embed_dims)
        self.value = nn.Linear(embed_dims, embed_dims)
        self.out = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, query_pos=None):
        b, nq, c = query.shape
        x = query if query_pos is None else query + query_pos
        nh = self.num_heads

        def heads(t):
            return t.reshape(b, nq, nh, c // nh).transpose(1, 2)

        q, k, v = (heads(self.query(x)), heads(self.key(x)),
                   heads(self.value(query)))
        scores = at_least_f32(torch.matmul(q, k.transpose(-1, -2)))
        weights = torch.softmax(scores * (1.0 / math.sqrt(c // nh)), -1)
        out = torch.matmul(weights.to(v.dtype), v)
        return self.out(out.transpose(1, 2).reshape(b, nq, c)) + query
