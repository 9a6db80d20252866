"""Info-PKL-backed datasets producing static-shape NumPy batches.

Parity target: ``NewScenesDataset``
(reference ``datasets/newscenes_dataset.py``) — loads info files sorted
by timestamp, filters GT by ``valid_flag``, maps names to the 4 eval
classes, emits velocity-augmented 9-dim boxes, formats predictions into
the NewScenes result JSON (gravity center, wlh, ``-yaw - pi/2`` -> yaw
quaternion, per-class rectangular range drop,
``newscenes_dataset.py:537-583``) and calls the devkit eval.

Unlike the reference (torch DataLoader + DataContainer), samples are
plain dicts of fixed-shape NumPy arrays ready for device upload.

Restated from ``omnihd_scenes_tpu/data/dataset.py`` for the point-cloud
modalities (``'radar'``, ``'lidar'``): the same seeded ``RandomState``
draws, hence the same samples bit for bit.  The camera data path (images,
depth targets, augmentation) and occupancy GT need OpenCV-based loaders
that are not ported yet; their options are refused.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from omnihd_scenes_tpu_torch.data.lidar_loading import load_lidar_multisweep
from omnihd_scenes_tpu_torch.data.radar_loading import load_radar_points_multisweep
from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

CLASSES = ('car', 'pedestrian', 'rider', 'large_vehicle')


def load_infos(ann_file: str) -> List[Dict]:
    """Load an info pkl, sorted by timestamp (reference behavior)."""
    with open(ann_file, 'rb') as f:
        data = pickle.load(f)
    return sorted(data['infos'], key=lambda e: e['timestamp'])


class NewScenesDetDataset:
    """Point-cloud detection dataset (radar or lidar modality)."""

    def __init__(self,
                 ann_file: str,
                 modality: str = 'radar',
                 classes: Sequence[str] = CLASSES,
                 pc_range: Sequence[float] = (-60, -40, -3.0, 60, 40, 5.0),
                 max_points: int = 40000,
                 max_gt: int = 128,
                 radar_sweeps: int = 3,
                 radar_use_dim: Sequence[int] = (0, 1, 2, 3, 4, 5, 6, 7),
                 lidar_load_dim: int = 5,
                 lidar_use_dim: int = 4,
                 lidar_sweeps: int = 0,
                 use_valid_flag: bool = True,
                 test_mode: bool = False,
                 point_shuffle: bool = False,
                 use_camera: bool = False,
                 image_scale: float = 0.5,
                 front_back_scale: float = 0.5,
                 image_target_hw: Optional[Sequence[int]] = None,
                 image_fast_decode: bool = False,
                 load_depth_gt: bool = False,
                 depth_stride: int = 4,
                 camera_depth_range: Sequence[float] = (1.0, 60.0, 1.0),
                 load_occ: bool = False,
                 occ_size: Sequence[int] = (240, 160, 16),
                 occ_downsample: Sequence[int] = (1, 1, 1),
                 aug: Optional[Dict] = None,
                 seed: int = 0):
        unported = {'modality=camera': modality == 'camera',
                    'use_camera': use_camera, 'load_depth_gt': load_depth_gt,
                    'load_occ': load_occ, 'aug': bool(aug)}
        bad = sorted(k for k, v in unported.items() if v)
        if bad:
            raise NotImplementedError(
                f'not ported yet: {bad} (ROADMAP queue 1 item 3: image and '
                f'depth loading, augmentation, the occupancy eval)')
        if modality not in ('radar', 'lidar'):
            raise ValueError(f'unknown modality {modality!r}')
        self.infos = load_infos(ann_file)
        self.modality = modality
        self.classes = list(classes)
        self.pc_range = list(pc_range)
        self.max_points = max_points
        self.max_gt = max_gt
        self.radar_sweeps = radar_sweeps
        self.radar_use_dim = list(radar_use_dim)
        self.lidar_load_dim = lidar_load_dim
        self.lidar_use_dim = lidar_use_dim
        self.lidar_sweeps = lidar_sweeps
        self.use_valid_flag = use_valid_flag
        self.test_mode = test_mode
        self.point_shuffle = point_shuffle
        self.use_camera = use_camera
        self.image_scale = image_scale
        self.front_back_scale = front_back_scale
        self.image_target_hw = (tuple(image_target_hw)
                                if image_target_hw else None)
        # Serving decode path: reduced-res JPEG decode + fused
        # undistort/rescale remap (image_loading._load_cam_fast).
        self.image_fast_decode = image_fast_decode
        self.load_depth_gt = load_depth_gt
        self.depth_stride = depth_stride
        self.camera_depth_range = list(camera_depth_range)
        self.load_occ = load_occ
        self.occ_size = tuple(occ_size)
        self.occ_downsample = tuple(occ_downsample)
        # Training-time augmentation config (reference train pipelines):
        # {'photometric': True,
        #  'crop_resize_flip': {'resize': [...], 'crop': (...),
        #                       'rand_flip': True},
        #  'rot_scale_flip_image': {...},   # camera models (degrees)
        #  'rot_scale_flip': {...}}         # point models (radians)
        self.aug = dict(aug) if aug else None
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    @property
    def point_dim(self) -> int:
        if self.modality == 'radar':
            return len(self.radar_use_dim)
        return self.lidar_use_dim + (1 if self.lidar_sweeps > 0 else 0)

    def scene_tokens(self) -> List[str]:
        return [info['scene_token'] for info in self.infos]

    # -- loading ------------------------------------------------------------
    def _load_points(self, info: Dict):
        if self.modality == 'radar':
            return load_radar_points_multisweep(
                info['radars'], sweeps_num=self.radar_sweeps,
                use_dim=self.radar_use_dim, max_num=self.max_points,
                pc_range=self.pc_range, rng=self.rng)
        if self.lidar_sweeps > 0:
            return load_lidar_multisweep(
                info, load_dim=self.lidar_load_dim,
                use_dim=self.lidar_use_dim, max_sweeps=self.lidar_sweeps,
                max_num=self.max_points, pc_range=self.pc_range, rng=self.rng)
        from omnihd_scenes_tpu_torch.data.lidar_loading import load_lidar_points
        from omnihd_scenes_tpu_torch.data.radar_loading import pad_or_drop
        pts = load_lidar_points(info['lidar_path'], self.lidar_load_dim,
                                self.lidar_use_dim)
        keep = ((pts[:, 0] > self.pc_range[0]) & (pts[:, 0] < self.pc_range[3])
                & (pts[:, 1] > self.pc_range[1]) & (pts[:, 1] < self.pc_range[4])
                & (pts[:, 2] > self.pc_range[2]) & (pts[:, 2] < self.pc_range[5]))
        return pad_or_drop(pts[keep], self.max_points, self.rng)

    def _load_annotations(self, info: Dict):
        """GT boxes as padded (max_gt, 9) + labels + mask.

        Velocity NaNs -> 0, names -> class ids, optional valid_flag +
        range filters (reference ``get_ann_info`` + ObjectRangeFilter).
        """
        mask = (info['valid_flag'] if self.use_valid_flag
                else np.ones(len(info['gt_boxes']), bool))
        gt_boxes = info['gt_boxes'][mask].astype(np.float32)
        gt_names = info['gt_names'][mask]
        gt_vel = info['gt_velocity'][mask].astype(np.float32)
        gt_vel = np.nan_to_num(gt_vel, nan=0.0)

        labels = np.array([self.classes.index(n) if n in self.classes else -1
                           for n in gt_names], dtype=np.int32)

        boxes9 = np.concatenate([gt_boxes, gt_vel], axis=1)
        # info gt z is the box center (devkit frame); model uses bottom z.
        boxes9[:, 2] -= boxes9[:, 5] * 0.5

        # ObjectRangeFilter on BEV centers + name filter.
        keep = ((boxes9[:, 0] > self.pc_range[0])
                & (boxes9[:, 0] < self.pc_range[3])
                & (boxes9[:, 1] > self.pc_range[1])
                & (boxes9[:, 1] < self.pc_range[4])
                & (labels >= 0))
        boxes9, labels = boxes9[keep], labels[keep]

        n = min(len(boxes9), self.max_gt)
        out_boxes = np.zeros((self.max_gt, 9), np.float32)
        out_labels = np.zeros((self.max_gt,), np.int32)
        out_mask = np.zeros((self.max_gt,), bool)
        out_boxes[:n] = boxes9[:n]
        out_labels[:n] = labels[:n]
        out_mask[:n] = True
        # Keep padded rows degenerate but finite for IoU code.
        out_boxes[n:, 3:6] = 1.0
        out_boxes[n:, :2] = -1e4
        return out_boxes, out_labels, out_mask

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        sample = {'index': np.int32(idx)}
        points, pmask = self._load_points(info)
        if self.point_shuffle and not self.test_mode:
            perm = self.rng.permutation(points.shape[0])
            points, pmask = points[perm], pmask[perm]
        sample.update(points=points, points_mask=pmask)
        if not self.test_mode:
            boxes, labels, mask = self._load_annotations(info)
            sample.update(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)
        return sample

    # -- result formatting / evaluation -------------------------------------
    def format_results(self, results: List[Dict], jsonfile_prefix: str,
                       class_range: Optional[Dict] = None) -> str:
        """Padded per-sample predictions -> NewScenes result JSON.

        ``results[i]`` carries 'boxes' (K, 9), 'scores' (K,),
        'labels' (K,), 'valid' (K,) for sample index i (dataset order).
        """
        if class_range is None:
            class_range = {c: [60, 40] for c in self.classes}
        annos = {}
        for i, det in enumerate(results):
            token = self.infos[i]['token']
            sample_annos = []
            boxes = np.asarray(det['boxes'])
            scores = np.asarray(det['scores'])
            labels = np.asarray(det['labels'])
            valid = np.asarray(det['valid'])
            for k in np.nonzero(valid)[0]:
                box = boxes[k]
                name = self.classes[int(labels[k])]
                rng_xy = class_range[name]
                if abs(box[0]) > rng_xy[0] or abs(box[1]) > rng_xy[1]:
                    continue
                # gravity center + wlh + devkit yaw convention.
                yaw = float(-box[6] - np.pi / 2)
                quat = Quaternion(axis=[0, 0, 1], radians=yaw)
                sample_annos.append(dict(
                    sample_token=token,
                    translation=[float(box[0]), float(box[1]),
                                 float(box[2] + box[5] / 2)],
                    size=[float(box[3]), float(box[4]), float(box[5])],
                    rotation=quat.elements.tolist(),
                    velocity=[float(box[7]), float(box[8])],
                    detection_name=name,
                    detection_score=float(scores[k]),
                ))
            annos[token] = sample_annos

        submission = {
            'meta': dict(use_lidar=self.modality == 'lidar',
                         use_camera=self.use_camera,
                         use_radar=self.modality == 'radar'),
            'results': annos,
        }
        os.makedirs(jsonfile_prefix, exist_ok=True)
        res_path = osp.join(jsonfile_prefix, 'results_newsc.json')
        with open(res_path, 'w') as f:
            json.dump(submission, f)
        return res_path

    def evaluate(self, results: List[Dict], dataroot: str, version: str,
                 eval_set: str, jsonfile_prefix: str,
                 bad_conditions: bool = False,
                 verbose: bool = False) -> Dict[str, float]:
        """Run the devkit detection eval on formatted results."""
        from omnihd_scenes_tpu_torch.devkit.database import NewScenes
        from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
        from omnihd_scenes_tpu_torch.eval.detection.evaluate import DetectionEval

        cfg = config_factory('detection_newsc_config_final')
        res_path = self.format_results(results, jsonfile_prefix,
                                       cfg.class_range)
        newsc = NewScenes(version=version, dataroot=dataroot, verbose=verbose)
        ev = DetectionEval(newsc, config=cfg, result_path=res_path,
                           eval_set=eval_set,
                           output_dir=osp.join(jsonfile_prefix, 'metrics'),
                           verbose=verbose, bad_conditions=bad_conditions)
        metrics, _ = ev.evaluate()
        summary = metrics.serialize()
        out = {'mAP': summary['mean_ap'], 'NOS': summary['NOS']}
        for k, v in summary['tp_errors'].items():
            out[k] = v
        for name, ap in summary['mean_dist_aps'].items():
            out[f'AP_{name}'] = ap
        return out
