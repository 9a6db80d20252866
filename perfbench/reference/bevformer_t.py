"""Plain float32 reference of BEVFormer-T streamed one frame a call:
ResNet -> FPN -> the temporal encoder (TSA over the carried, ego-motion
aligned BEV and SCA into the cameras, by ``F.grid_sample``) -> the DETR
decoder with iterative refinement -> the NMS-free decode.

A frozen copy of the port's modules at the time the benchmark was defined
(``models/bevformer/``, ``ops/ms_deform_attn.py``,
``models/bbox_coder.py``; the port runs no hand kernel on this path), in
float32 with every BatchNorm on its running statistics.  Module and
parameter names are the port's, so one state dict loads into both.
Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.common import FPN, ResNet

# ---- multi-scale deformable attention (ops/ms_deform_attn.py) ---------------

# The f32 tensor of sampled taps (batch, heads, head_dim, queries, points)
# of one query chunk is kept under this many elements (256 MB), the
# bound of the JAX package's chunking (``ops/ms_deform_attn.py:361``).
CHUNK_ELEMENTS = 64_000_000


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in its own dtype where that is wider (f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bilinear_sample(value: torch.Tensor, loc_xy: torch.Tensor) -> torch.Tensor:
    """Sample ``value`` (B, H, W, C) at ``loc_xy`` (B, ..., 2), continuous
    pixel coordinates where (0, 0) is the centre of the top-left texel ->
    (B, ..., C) in the promoted dtype of value and locations.

    The JAX package's form: one 2x2 patch per location whose anchor is
    clipped into the map, so each in-map tap of the support is covered and
    out-of-map taps weigh 0.  A map of height or width 1 is padded with
    zeros to 2 first.  A patch column X weighs ``1 - f`` where X is
    ``floor(x)``, ``f`` where X is ``floor(x) + 1`` and 0 elsewhere, with
    ``f = x - floor(x)`` (rows alike): JAX's tent ``relu(1 - |x - X|)`` in
    value, but with the floor-side derivative at a tap exactly on a texel
    centre, the side ``F.grid_sample`` and mmcv's kernels take (JAX's tent
    takes neither side there; ROADMAP queue 3 item 17).
    """
    b, h, w, c = value.shape
    if h < 2 or w < 2:
        value = F.pad(value, (0, 0, 0, max(0, 2 - w), 0, max(0, 2 - h)))
        h, w = max(h, 2), max(w, 2)
    x, y = loc_xy[..., 0], loc_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ys = y0.clamp(0, h - 2).long()
    xs = x0.clamp(0, w - 2).long()
    offs = torch.arange(2, device=value.device)

    def weights(t, t0, start):
        frac = (t - t0)[..., None]
        col = start[..., None] + offs - t0.long()[..., None]   # X - floor(t)
        return torch.where(col == 0, 1.0 - frac,
                           torch.where(col == 1, frac, 0.0))

    wx, wy = weights(x, x0, xs), weights(y, y0, ys)
    flat = value.reshape(b, h * w, c)
    out = 0.0
    for a in range(2):
        for d in range(2):
            idx = ((ys + a) * w + (xs + d)).reshape(b, -1, 1)
            tap = torch.gather(flat, 1, idx.expand(-1, -1, c))
            out = out + tap.reshape(*x.shape, c) * (
                wy[..., a] * wx[..., d])[..., None]
    return out


def _level_values(value, spatial_shapes, dtype=None):
    """(B, S, heads, hd) -> per level (B * heads, hd, H, W) in ``dtype``
    (default: at least f32)."""
    b, _, nh, hd = value.shape
    dtype = dtype or torch.promote_types(value.dtype, torch.float32)
    out, start = [], 0
    for h, w in spatial_shapes:
        v = value[:, start:start + h * w].to(dtype)
        start += h * w
        out.append(v.permute(0, 2, 3, 1).reshape(b * nh, hd, h, w))
    return out


def _sample_chunk(levels, loc, weights):
    """One query chunk: loc (B, q, heads, L, P, 2), weights (B, q, heads,
    L, P) -> (B * heads, hd, q) in the levels' dtype."""
    b, q, nh, _, p, _ = loc.shape
    dtype = levels[0].dtype
    acc = 0.0
    for lvl, v in enumerate(levels):
        grid = loc[:, :, :, lvl].to(dtype).permute(0, 2, 1, 3, 4).reshape(
            b * nh, q, p, 2) * 2.0 - 1.0
        taps = F.grid_sample(v, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=False)       # (B*nh, hd, q, P)
        wgt = weights[:, :, :, lvl].to(dtype).permute(0, 2, 1, 3).reshape(
            b * nh, 1, q, p)
        acc = acc + (taps * wgt).sum(-1)
    return acc


def multi_scale_deformable_attn(value: torch.Tensor,
                                spatial_shapes: Sequence[Tuple[int, int]],
                                sampling_locations: torch.Tensor,
                                attention_weights: torch.Tensor,
                                query_chunk: Optional[int] = None
                                ) -> torch.Tensor:
    """Deformable attention.

    Args:
        value: (B, sum_l H_l * W_l, num_heads, head_dim).
        spatial_shapes: static list of (H_l, W_l).
        sampling_locations: (B, num_query, num_heads, num_levels,
            num_points, 2) normalised to [0, 1], (x, y).
        attention_weights: (B, num_query, num_heads, num_levels,
            num_points).
        query_chunk: queries per ``grid_sample`` call; None bounds the f32
            tap tensor of a chunk to ``CHUNK_ELEMENTS``.

    Returns:
        (B, num_query, num_heads * head_dim) in value's dtype.
    """
    b, nq, nh, _, p, _ = sampling_locations.shape
    hd = value.shape[-1]
    if query_chunk is None:
        query_chunk = max(256, CHUNK_ELEMENTS // max(b * nh * p * hd, 1))
    levels = _level_values(value, spatial_shapes, torch.promote_types(
        torch.promote_types(value.dtype, sampling_locations.dtype),
        torch.float32))
    out = torch.cat([
        _sample_chunk(levels, sampling_locations[:, s:s + query_chunk],
                      attention_weights[:, s:s + query_chunk])
        for s in range(0, nq, query_chunk)], -1)         # (B*nh, hd, nq)
    return out.reshape(b, nh * hd, nq).transpose(1, 2).to(value.dtype)



# ---- models/bevformer/attention.py -------------------------------------

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


def _normalizer(spatial_shapes, device) -> torch.Tensor:
    """(L, 2) reciprocal (W, H) per level, as f32 multiplies."""
    return torch.tensor([[1.0 / w, 1.0 / h] for h, w in spatial_shapes],
                        dtype=torch.float32, device=device)


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


# ---- models/bevformer/encoder.py ---------------------------------------

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
        ref_3d, ref_2d = (torch.from_numpy(r).to(dev) for r in self._ref_np)
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


# ---- models/bevformer/decoder.py ---------------------------------------

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


# ---- models/bevformer/transformer.py -----------------------------------

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
        return self.encoder(queries, bev_pos, cam_values, lidar2img, img_hw,
                            cam_shapes, prev_bev=prev_bev, shift=shift,
                            has_prev=has_prev)

    def forward(self, mlvl_feats, bev_queries, object_query_embed, bev_pos,
                can_bus, lidar2img, img_hw, reg_branch_fn, prev_bev=None,
                has_prev=None):
        """Encode + decode; returns (bev_embed, hs, refs)."""
        bev_embed = self.get_bev_features(
            mlvl_feats, bev_queries, bev_pos, can_bus, lidar2img, img_hw,
            prev_bev=prev_bev, has_prev=has_prev)
        b = bev_embed.shape[0]
        query_pos, query = object_query_embed.chunk(2, -1)
        reference_points = torch.sigmoid(
            at_least_f32(self.reference_points_fc(query_pos)))
        hs, refs = self.decoder(
            query.expand(b, *query.shape), query_pos.expand(b, *query.shape),
            bev_embed, reference_points.expand(b, *reference_points.shape),
            ((self.bev_h, self.bev_w),), reg_branch_fn)
        return bev_embed, hs, refs


# ---- models/bevformer/head.py ------------------------------------------

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


# ---- models/bbox_coder.py ----------------------------------------------

class NMSFreeCoderCfg(NamedTuple):
    post_center_range: Sequence[float] = (-70, -50, -10.0, 70, 50, 10.0)
    max_num: int = 300
    num_classes: int = 4
    score_threshold: float = None


def normalize_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) [x, y, z_bottom, w, l, h, yaw, vx, vy] -> (..., 10) code."""
    cx, cy, z, w, l, h, rot, vx, vy = boxes.unbind(-1)
    return torch.stack([cx, cy, w.log(), l.log(), z + h * 0.5, h.log(),
                        rot.sin(), rot.cos(), vx, vy], -1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """(..., 10) code -> (..., 9) box (bottom-centred z)."""
    cx, cy, w_log, l_log, cz, h_log, rot_s, rot_c, vx, vy = code.unbind(-1)
    h = h_log.exp()
    return torch.stack([cx, cy, cz - h * 0.5, w_log.exp(), l_log.exp(), h,
                        torch.atan2(rot_s, rot_c), vx, vy], -1)


def nms_free_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                    cfg: NMSFreeCoderCfg = NMSFreeCoderCfg()):
    """Decode the final decoder layer's outputs.

    cls_scores (B, num_query, num_classes) logits; bbox_preds (B,
    num_query, 10) codes.  Returns boxes (B, max_num, 9), scores (B,
    max_num), labels (B, max_num) int32 and valid (B, max_num) bool, all
    on the inputs' device.
    """
    scores = cls_scores.sigmoid()
    b, nq, nc = scores.shape
    k = min(cfg.max_num, nq * nc)
    top_scores, top_idx = scores.reshape(b, -1).topk(k, dim=-1)
    labels = (top_idx % nc).to(torch.int32)
    query_idx = top_idx // nc
    boxes = denormalize_bbox(torch.gather(
        bbox_preds, 1, query_idx[..., None].expand(-1, -1,
                                                   bbox_preds.shape[-1])))
    center = (boxes[..., 0], boxes[..., 1],
              boxes[..., 2] + boxes[..., 5] * 0.5)          # gravity z
    lo, hi = cfg.post_center_range[:3], cfg.post_center_range[3:]
    # Python bounds: no host-to-device copy, so the host never waits.
    valid = torch.ones_like(top_scores, dtype=torch.bool)
    for c, a, z in zip(center, lo, hi):
        valid = valid & (c >= a) & (c <= z)
    if cfg.score_threshold is not None:
        valid = valid & (top_scores > cfg.score_threshold)
    if k < cfg.max_num:
        pad = cfg.max_num - k
        boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 9)], 1)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(b, pad)], 1)
        labels = torch.cat([labels, labels.new_zeros(b, pad)], 1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], 1)
    return boxes, top_scores, labels, valid



# ---- the detector -----------------------------------------------------------

def check_supported(model: dict) -> None:
    if any(model['stage_with_dcn']):
        raise NotImplementedError('the reference has no DCNv2')


class BEVFormerDetector(nn.Module):
    """ResNet (frozen BN) + FPN + :class:`BEVFormerHead`."""

    def __init__(self, cfg: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.img_backbone = ResNet(cfg['resnet_depth'],
                                   cfg['resnet_out_indices'])
        self.img_neck = FPN(self.img_backbone.out_channels,
                            cfg['embed_dims'])
        self.pts_bbox_head = BEVFormerHead(
            bev_h=cfg['bev_h'], bev_w=cfg['bev_w'],
            num_query=cfg['num_query'], num_classes=cfg['num_classes'],
            embed_dims=cfg['embed_dims'],
            encoder_layers=cfg['encoder_layers'],
            decoder_layers=cfg['decoder_layers'], num_cams=cfg['num_cams'],
            pc_range=cfg['pc_range'], sca_query_cap=cfg['sca_query_cap'])

    def extract_img_feat(self, imgs):
        b, n = imgs.shape[:2]
        flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
        return self.img_neck(self.img_backbone(flat))[:self.cfg['fpn_outs']]

    def forward_stream(self, imgs, can_bus, lidar2img, prev_bev, has_prev):
        """One frame of B streams: imgs (B, N, H, W, 3); can_bus (B, 18)
        relative; lidar2img (B, N, 4, 4); prev_bev (B, nq, C); has_prev
        (B,) bool."""
        return self.pts_bbox_head(self.extract_img_feat(imgs), can_bus,
                                  lidar2img, tuple(imgs.shape[2:4]),
                                  prev_bev=prev_bev, has_prev=has_prev)


def build(model: dict) -> BEVFormerDetector:
    return BEVFormerDetector(model)
