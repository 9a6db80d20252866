"""Temporal (frame-queue) dataset for BEVFormer (counterpart of
``omnihd_scenes_tpu/data/temporal_dataset.py``; reference
``CustomNewScenesDataset``, ``datasets/custom_newscenes_dataset.py:
27-200``).

- :func:`finalize_can_bus`: per frame, [:3] = ego translation, [3:7] =
  rotation quaternion, [-2] = patch yaw in radians, [-1] = patch yaw in
  degrees (``:172-184``);
- training queues of ``queue_length`` frames: one of the predecessors
  dropped at random, the rest sorted, then the current frame (``:45-48``);
- ``union2one``: can_bus rewritten to per-frame deltas (position and
  patch angle) with ``has_prev`` scene-boundary flags (``:63-91``).

Test mode yields single frames with the absolute can_bus; with
``image_decode='device'`` a frame (test mode) or a queue (training,
``image_loading.stack_camera_sources``: (T, ...) arrays, the JPEG bytes
concatenated with (T, N + 1) offsets) carries its cameras' JPEG sources
in place of ``imgs``, which ``image_loading.decode_camera_batch`` turns
into the (B, T, N, H, W, 3) queue;
:class:`StreamingEvalState` keeps (prev_bev, prev_pos, prev_angle) on the
host and computes the deltas (reference ``bevformer.py:270-306``).  The
samples are the JAX package's, with the same seeded draws, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
from omnihd_scenes_tpu_torch.data.image_loading import (
    CAMERA_SOURCE_KEYS, stack_camera_sources)
from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion


def finalize_can_bus(info: Dict) -> np.ndarray:
    """The absolute can_bus with the patch-angle fields."""
    can_bus = np.array(info['can_bus'], np.float64).copy()
    rotation = Quaternion(np.asarray(info['ego2global_rotation']))
    can_bus[:3] = np.asarray(info['ego2global_translation'])
    can_bus[3:7] = rotation.elements
    v = rotation.rotation_matrix @ np.array([1.0, 0.0, 0.0])
    patch_angle = np.arctan2(v[1], v[0]) / np.pi * 180.0
    if patch_angle < 0:
        patch_angle += 360.0
    can_bus[-2] = patch_angle / 180.0 * np.pi
    can_bus[-1] = patch_angle
    return can_bus.astype(np.float32)


class TemporalNewScenesDataset(NewScenesDetDataset):
    """Frame-queue camera dataset."""

    def __init__(self, *args, queue_length: int = 3, **kwargs):
        kwargs.setdefault('use_camera', True)
        kwargs.setdefault('modality', 'camera')
        super().__init__(*args, **kwargs)
        self.queue_length = queue_length

    def _queue_indices(self, index: int) -> List[int]:
        cands = list(range(index - self.queue_length, index))
        self.rng.shuffle(cands)
        cands = sorted(cands[1:])
        cands.append(index)
        return [max(0, i) for i in cands]

    def _frame(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        cam = self._load_camera(info)
        return {**{k: cam[k] for k in self._pixel_keys()},
                'lidar2img': cam['lidar2img'],
                'can_bus': finalize_can_bus(info),
                'scene_token': info['scene_token']}

    def _pixel_keys(self):
        return ('imgs',) if self.image_decode == 'host' else CAMERA_SOURCE_KEYS

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.test_mode:
            info = self.infos[idx]
            cam = self._load_camera(info)
            return {**{k: cam[k] for k in self._pixel_keys()},
                    'lidar2img': cam['lidar2img'],
                    'can_bus': finalize_can_bus(info), 'index': np.int32(idx)}

        frames = [self._frame(i) for i in self._queue_indices(idx)]
        # union2one: relative can_bus + scene-boundary flags.
        prev_scene = prev_pos = prev_angle = None
        has_prev = []
        for f in frames:
            cb = f['can_bus']
            if f['scene_token'] != prev_scene:
                has_prev.append(False)
                prev_scene = f['scene_token']
                prev_pos, prev_angle = cb[:3].copy(), float(cb[-1])
                cb[:3] = 0.0
                cb[-1] = 0.0
            else:
                has_prev.append(True)
                tmp_pos, tmp_angle = cb[:3].copy(), float(cb[-1])
                cb[:3] -= prev_pos
                cb[-1] -= prev_angle
                prev_pos, prev_angle = tmp_pos, tmp_angle

        boxes, labels, mask = self._load_annotations(self.infos[idx])
        pixels = ({'imgs': np.stack([f['imgs'] for f in frames])}
                  if self.image_decode == 'host'
                  else stack_camera_sources(frames))
        return {**pixels,
                'lidar2img': np.stack([f['lidar2img'] for f in frames]),
                'can_bus': np.stack([f['can_bus'] for f in frames]),
                'has_prev': np.asarray(has_prev),
                'gt_boxes': boxes, 'gt_labels': labels, 'gt_mask': mask,
                'index': np.int32(idx)}


class StreamingEvalState:
    """One stream's prev_frame_info (reference ``bevformer.py:60-65,
    270-306``).  ``prev_bev`` is whatever the caller stores: a host array
    or, for the port's predictor, a tensor that stays on the card."""

    def __init__(self, bev_shape):
        self.prev_bev = np.zeros(bev_shape, np.float32)
        self.has_prev = False
        self.prev_scene = None
        self.prev_pos = np.zeros(3)
        self.prev_angle = 0.0

    def prepare(self, can_bus_abs: np.ndarray, scene_token: str):
        """The incoming frame's relative can_bus and has_prev flag."""
        cb = can_bus_abs.copy()
        if scene_token != self.prev_scene:
            self.has_prev = False
        tmp_pos, tmp_angle = cb[:3].copy(), float(cb[-1])
        if self.has_prev:
            cb[:3] -= self.prev_pos
            cb[-1] -= self.prev_angle
        else:
            cb[:3] = 0.0
            cb[-1] = 0.0
        self.prev_scene = scene_token
        self.prev_pos, self.prev_angle = tmp_pos, tmp_angle
        return cb, self.has_prev

    def update(self, new_bev):
        self.prev_bev = new_bev
        self.has_prev = True
