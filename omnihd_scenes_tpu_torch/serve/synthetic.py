"""Seeded random weights and requests for driving the serving path
without a checkpoint or a dataset (smoke tests and profiles)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_img2lidar
from omnihd_scenes_tpu_torch.weights import init_weights

N_POINTS = 40000


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
