"""Seeded random weights, requests and training batches for driving the
serving and training paths without a checkpoint or a dataset (smoke
tests and profiles)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_img2lidar
from omnihd_scenes_tpu_torch.weights import init_weights

N_POINTS = 40000
MAX_GT = 64


def random_state_dict(cfg: BEVFusionConfig,
                      seed: int) -> Dict[str, torch.Tensor]:
    """A ``BEVFusion(cfg)`` state_dict of seeded random weights (CPU, f32)."""
    return init_weights(BEVFusion(cfg),
                        torch.Generator().manual_seed(seed)).state_dict()


def random_request(rng: np.random.RandomState, cfg: BEVFusionConfig,
                   batch: int, n_points: int = N_POINTS):
    """Fresh ``Predictor`` inputs drawn as ``bench.py:main`` draws them:
    radar points uniform inside the range, all valid; N(0, 1) images; the
    ring rig for every sample."""
    x0, y0 = cfg.pillars.point_cloud_range[:2]
    points = rng.uniform(x0 + 5, -x0 - 5, size=(batch, n_points, 8)).astype(
        np.float32)
    points[..., 1] = rng.uniform(y0 + 2, -y0 - 2, size=(batch, n_points))
    points[..., 2] = rng.uniform(-2, 4, size=(batch, n_points))
    mask = np.ones((batch, n_points), dtype=bool)
    h, w = cfg.lss.final_dim
    imgs = rng.randn(batch, cfg.num_views, h, w, 3).astype(np.float32)
    rots, trans = ring_rig_img2lidar(img_hw=(h, w))
    return (points, mask, imgs, np.tile(rots[None], (batch, 1, 1, 1)),
            np.tile(trans[None], (batch, 1, 1)))


def random_train_batch(rng: np.random.RandomState, cfg: BEVFusionConfig,
                       batch: int, n_points: int = N_POINTS,
                       max_gt: int = MAX_GT,
                       depth: bool = True) -> Dict[str, np.ndarray]:
    """A training batch drawn as ``bench.py``'s train bench draws it:
    radar points uniform over +-50 m (all 8 dims), all valid; N(0, 1)
    images; the ring rig; ``max_gt`` GT boxes per sample, centres uniform
    over +-40 m, sizes 1-4 m, labels over the classes, all valid.  With
    ``depth``, also ``depth_gaussian`` (B, N, fH, fW, D), a normalised
    Gaussian (std 1 bin) around a per-pixel depth, and ``depth_min`` (B,
    N, fH, fW), that depth, 0 (no observation) on a fifth of the pixels."""
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
    return out
