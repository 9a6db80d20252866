"""Seeded random weights, requests and training batches for driving the
serving and training paths without a checkpoint or a dataset (smoke
tests and profiles)."""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import (BEVFormerConfig, BEVFusionConfig,
                                            MTLConfig)
from omnihd_scenes_tpu_torch.models.bevformer import (BEVFormerDetector,
                                                      init_bevformer)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL, occupancy_shape
from omnihd_scenes_tpu_torch.models.resnet import space_to_depth_np
from omnihd_scenes_tpu_torch.utils.rig import (ring_rig_img2lidar,
                                               ring_rig_lidar2img)
from omnihd_scenes_tpu_torch.weights import init_weights

N_POINTS = 40000
MAX_GT = 64
# The temporal dataset's GT padding (``NewScenesDetDataset.max_gt``).
QUEUE_MAX_GT = 128
# Occupancy GT shares: occupied voxels (classes 1..n_cls-1), unknown (255).
OCC_OCCUPIED = 0.05
OCC_UNKNOWN = 0.10
# Spread of the seeded BEVFormer offset and weight kernels: offsets of
# ~0.3 cells per unit of a LayerNormed 256-dim query.
OFFSET_STD = 0.02
# Spread of the seeded DCNv2 offset-conv kernels: offsets and mask logits
# of ~0.5 (pixels) over a 3x3 window of 256 channels of unit activations.
DCN_OFFSET_STD = 0.01

Config = Union[BEVFusionConfig, MTLConfig]


def _fusion(cfg: Config) -> BEVFusionConfig:
    return cfg.fusion if isinstance(cfg, MTLConfig) else cfg


def random_state_dict(cfg: Config, seed: int) -> Dict[str, torch.Tensor]:
    """A ``BEVFusion(cfg)`` (``BEVFusionMTL`` for an ``MTLConfig``)
    state_dict of seeded random weights (CPU, f32)."""
    model = (BEVFusionMTL(cfg) if isinstance(cfg, MTLConfig)
             else BEVFusion(cfg))
    return init_weights(model,
                        torch.Generator().manual_seed(seed)).state_dict()


def random_request(rng: np.random.RandomState, cfg: Config,
                   batch: int, n_points: int = N_POINTS):
    """Fresh ``Predictor`` inputs drawn as ``bench.py:main`` draws them:
    radar points uniform inside the range, all valid; N(0, 1) images
    (space-to-depth packed on the host with ``stem_s2d``, as ``bench.py
    --s2d`` packs them); the ring rig for every sample.  The images and
    the rig are drawn whatever the streams, and the inputs of a stream
    the model lacks are None."""
    cfg = _fusion(cfg)
    x0, y0 = cfg.pillars.point_cloud_range[:2]
    points = rng.uniform(x0 + 5, -x0 - 5, size=(batch, n_points, 8)).astype(
        np.float32)
    points[..., 1] = rng.uniform(y0 + 2, -y0 - 2, size=(batch, n_points))
    points[..., 2] = rng.uniform(-2, 4, size=(batch, n_points))
    mask = np.ones((batch, n_points), dtype=bool)
    h, w = cfg.lss.final_dim
    imgs = rng.randn(batch, cfg.num_views, h, w, 3).astype(np.float32)
    if cfg.stem_s2d:
        imgs = space_to_depth_np(imgs)
    rots, trans = ring_rig_img2lidar(img_hw=(h, w))
    camera = (imgs, np.tile(rots[None], (batch, 1, 1, 1)),
              np.tile(trans[None], (batch, 1, 1)))
    if not cfg.camera_stream:
        camera = (None,) * 3
    return (points, mask) + camera


def random_train_batch(rng: np.random.RandomState, cfg: Config,
                       batch: int, n_points: int = N_POINTS,
                       max_gt: int = MAX_GT,
                       depth: bool = True) -> Dict[str, np.ndarray]:
    """A training batch drawn as ``bench.py``'s train bench draws it (its
    remat arms included: remat changes the model, not the batch): radar
    points uniform over +-50 m (all 8 dims), all valid; N(0, 1) images,
    space-to-depth packed with ``stem_s2d``; the ring rig; without the
    camera stream neither images nor geometry nor depth targets (drawn all
    the same, so the other entries do not change); ``max_gt`` GT boxes
    per sample, centres uniform
    over +-40 m, sizes 1-4 m, labels over the classes, all valid.  With
    ``depth``, also ``depth_gaussian`` (B, N, fH, fW, D), a normalised
    Gaussian (std 1 bin) around a per-pixel depth, and ``depth_min`` (B,
    N, fH, fW), that depth, 0 (no observation) on a fifth of the pixels.
    For an ``MTLConfig``, also ``gt_occ`` (B, Dx, Dy, Dz) uint8 on the
    occupancy head's grid (240x160x16 at full width): each voxel occupied
    with probability ``OCC_OCCUPIED`` (a class uniform over 1..n_cls-1),
    unknown (255) with ``OCC_UNKNOWN``, free (0) otherwise."""
    mtl = cfg if isinstance(cfg, MTLConfig) else None
    cfg = _fusion(cfg)
    h, w = cfg.lss.final_dim
    n_views = cfg.num_views
    rots, trans = ring_rig_img2lidar(img_hw=(h, w))
    gt_boxes = rng.uniform(-40, 40, (batch, max_gt, 9)).astype(np.float32)
    gt_boxes[..., 3:6] = rng.uniform(1, 4, (batch, max_gt, 3))
    out = {
        'points': rng.uniform(-50, 50, (batch, n_points, 8)).astype(
            np.float32),
        'points_mask': np.ones((batch, n_points), bool),
        'imgs': rng.randn(batch, n_views, h, w, 3).astype(np.float32),
        'img2lidar_rots': np.tile(rots[None], (batch, 1, 1, 1)),
        'img2lidar_trans': np.tile(trans[None], (batch, 1, 1)),
        'gt_boxes': gt_boxes,
        'gt_labels': rng.randint(0, cfg.pillars.num_classes,
                                 (batch, max_gt)).astype(np.int32),
        'gt_mask': np.ones((batch, max_gt), bool),
    }
    if depth:
        f_h, f_w = cfg.lss.feat_hw
        d0, d1, dd = cfg.lss.camera_depth_range
        centres = (d0 + dd * np.arange(cfg.lss.depth_bins)).astype(np.float32)
        shape = (batch, n_views, f_h, f_w)
        d_min = rng.uniform(d0, d1, shape).astype(np.float32)
        d_min[rng.uniform(size=shape) < 0.2] = 0.0
        g = np.exp(-0.5 * ((centres - d_min[..., None]) / dd) ** 2)
        out['depth_gaussian'] = (g / np.maximum(g.sum(-1, keepdims=True),
                                                1e-12)).astype(np.float32)
        out['depth_min'] = d_min
    if cfg.stem_s2d:
        out['imgs'] = space_to_depth_np(out['imgs'])
    if not cfg.camera_stream:
        for key in ('imgs', 'img2lidar_rots', 'img2lidar_trans',
                    'depth_gaussian', 'depth_min'):
            out.pop(key, None)
    if mtl is not None:
        shape = (batch, *occupancy_shape(mtl))
        u = rng.uniform(size=shape)
        occ = np.zeros(shape, np.uint8)
        occ[u < OCC_UNKNOWN + OCC_OCCUPIED] = 255
        hit = u < OCC_OCCUPIED
        occ[hit] = rng.randint(1, mtl.occ_classes, int(hit.sum()))
        out['gt_occ'] = occ
    return out


def random_bevformer_state_dict(cfg: BEVFormerConfig,
                                seed: int) -> Dict[str, torch.Tensor]:
    """A ``BEVFormerDetector(cfg)`` state_dict (CPU, f32) of flax's
    initialisation drawn from ``seed``, with the deformable attentions'
    offset and weight kernels drawn N(0, ``OFFSET_STD``) instead of zero,
    so that, as in a trained model, where each query samples and how it
    weighs its points depend on the query; likewise the DCNv2 offset
    convs' kernels (R101-DCN), N(0, ``DCN_OFFSET_STD``)."""
    gen = torch.Generator().manual_seed(seed)
    model = init_bevformer(init_weights(BEVFormerDetector(cfg), gen), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(('sampling_offsets.weight',
                              'attention_weights.weight')):
                p.copy_(torch.randn(p.shape, generator=gen) * OFFSET_STD)
            elif name.endswith('conv_offset.weight'):
                p.copy_(torch.randn(p.shape, generator=gen) * DCN_OFFSET_STD)
    return model.state_dict()


def random_stream_frame(rng: np.random.RandomState, cfg: BEVFormerConfig,
                        batch: int):
    """One frame of ``batch`` streams for ``StreamPredictor``: N(0, 1)
    images, a relative can_bus (a move of up to 1.5 m, a patch angle in
    radians at ``[-2]`` and a turn of up to 3 degrees at ``[-1]``, as
    ``StreamingEvalState`` gives them) and the ring rig's lidar2img."""
    h, w = cfg.img_hw
    imgs = rng.randn(batch, cfg.num_cams, h, w, 3).astype(np.float32)
    can_bus = np.zeros((batch, 18), np.float32)
    can_bus[:, :2] = rng.uniform(-1.5, 1.5, (batch, 2))
    can_bus[:, -2] = rng.uniform(0.0, 2 * np.pi, batch)
    can_bus[:, -1] = rng.uniform(-3.0, 3.0, batch)
    l2i = np.tile(ring_rig_lidar2img(img_hw=(h, w))[None], (batch, 1, 1, 1))
    return imgs, can_bus, l2i


def random_queue_batch(rng: np.random.RandomState, cfg: BEVFormerConfig,
                       batch: int, n_gt: int = 40,
                       max_gt: int = QUEUE_MAX_GT) -> Dict[str, np.ndarray]:
    """A BEVFormer training batch of ``batch`` frame queues of
    ``cfg.queue_length`` frames, as the temporal dataset's queue mode
    gives them: N(0, 1) images; the relative can_bus of ``union2one``
    (the first frame of a queue starts its scene: no move; the others a
    move of up to 1.5 m and a turn of up to 3 degrees; the patch angle in
    radians at ``[-2]``); the ring rig's lidar2img for every frame;
    ``has_prev`` false for the first frame only; ``n_gt`` valid GT boxes
    per sample, centres inside ``pc_range`` with a 2 m margin, sizes 0.5-4
    m, yaw over a turn, velocities up to 5 m/s, labels over the classes,
    padded with zeros to ``max_gt``."""
    q, h, w = cfg.queue_length, *cfg.img_hw
    imgs = rng.randn(batch, q, cfg.num_cams, h, w, 3).astype(np.float32)
    can_bus = np.zeros((batch, q, 18), np.float32)
    can_bus[:, :, -2] = rng.uniform(0.0, 2 * np.pi, (batch, q))
    can_bus[:, 1:, :2] = rng.uniform(-1.5, 1.5, (batch, q - 1, 2))
    can_bus[:, 1:, -1] = rng.uniform(-3.0, 3.0, (batch, q - 1))
    l2i = np.tile(ring_rig_lidar2img(img_hw=(h, w))[None, None],
                  (batch, q, 1, 1, 1))
    has_prev = np.ones((batch, q), bool)
    has_prev[:, 0] = False
    x0, y0, z0, x1, y1, z1 = cfg.pc_range
    size = rng.uniform(0.5, 4.0, (batch, n_gt, 3))
    valid = np.concatenate([
        rng.uniform(x0 + 2, x1 - 2, (batch, n_gt, 1)),
        rng.uniform(y0 + 2, y1 - 2, (batch, n_gt, 1)),
        rng.uniform(z0, z1 - size[..., 2:3]),
        size,
        rng.uniform(-np.pi, np.pi, (batch, n_gt, 1)),
        rng.uniform(-5.0, 5.0, (batch, n_gt, 2))], -1)
    gt_boxes = np.zeros((batch, max_gt, 9), np.float32)
    gt_boxes[:, :n_gt] = valid
    gt_labels = np.zeros((batch, max_gt), np.int32)
    gt_labels[:, :n_gt] = rng.randint(0, cfg.num_classes, (batch, n_gt))
    gt_mask = np.zeros((batch, max_gt), bool)
    gt_mask[:, :n_gt] = True
    return {'imgs': imgs, 'can_bus': can_bus, 'lidar2img': l2i,
            'has_prev': has_prev, 'gt_boxes': gt_boxes,
            'gt_labels': gt_labels, 'gt_mask': gt_mask}
