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

Restated from ``omnihd_scenes_tpu/data/dataset.py``: the point-cloud
modalities (``'radar'``, ``'lidar'``), ``modality='camera'`` (no points),
the cameras (``use_camera``; ``data/image_loading.py``, which needs
OpenCV), their depth targets (``load_depth_gt``) and the occupancy GT
(``load_occ``), and the training augmentation (``aug``,
``data/augmentation.py``), with the same seeded ``RandomState`` draws in
the same order, hence the same samples bit for bit.
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
    """Detection dataset: radar or LiDAR points, and/or the cameras, with
    optional depth targets and occupancy GT."""

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
        if modality not in ('radar', 'lidar', 'camera'):
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

    def _load_camera(self, info: Dict) -> Dict[str, np.ndarray]:
        from omnihd_scenes_tpu_torch.data.image_loading import load_camera_data

        cam = load_camera_data(info, scale=self.image_scale,
                               front_back_scale=self.front_back_scale,
                               target_hw=self.image_target_hw,
                               fast_decode=self.image_fast_decode)
        if self.load_depth_gt:
            from omnihd_scenes_tpu_torch.data.depth_loading import (
                gaussian_depth_target, load_gt_depth)

            hw = cam['imgs'].shape[1:3]
            gauss, mins = [], []
            for cam_type, cam_info in info['cams'].items():
                dmap = load_gt_depth(
                    cam_info['data_path'], hw, self.image_scale,
                    self.front_back_scale,
                    is_front_back=cam_type in ('camera_front',
                                               'camera_back'))
                g, m = gaussian_depth_target(dmap, self.depth_stride,
                                             self.camera_depth_range)
                gauss.append(g)
                mins.append(m)
            cam['depth_gaussian'] = np.stack(gauss)
            cam['depth_min'] = np.stack(mins)
        return cam

    def _load_occ(self, info: Dict) -> np.ndarray:
        """Occupancy GT: sparse (N, 4) [i, j, k, cls] npz -> dense grid.

        The occ path derives from the lidar path (reference
        ``tools/merge_data_with_occ.py:8-26``: lidar/*.bin ->
        occ_gt/*.npz); parity with ``LoadOccupancy_Newscenes``
        (``pipelines/loading.py:69-108``).
        """
        occ_path = info.get('occ_path')
        if occ_path is None:
            occ_path = info['lidar_path'].replace(
                '/lidar/', '/occ_gt/').replace('.bin', '.npz')
        occ = np.load(occ_path)['occ_gt']
        grid = np.zeros(self.occ_size, np.int32)
        grid[occ[:, 0].astype(int), occ[:, 1].astype(int),
             occ[:, 2].astype(int)] = occ[:, 3]
        dx, dy, dz = self.occ_downsample
        if (dx, dy, dz) != (1, 1, 1):
            # Max-pool downsample keeps sparse occupied labels visible
            # at reduced resolution (small-config testing only).
            sx, sy, sz = (self.occ_size[0] // dx, self.occ_size[1] // dy,
                          self.occ_size[2] // dz)
            grid = grid[:sx * dx, :sy * dy, :sz * dz].reshape(
                sx, dx, sy, dy, sz, dz).max(axis=(1, 3, 5))
        return grid

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        sample = {'index': np.int32(idx)}
        if self.modality in ('radar', 'lidar'):
            points, pmask = self._load_points(info)
            if self.point_shuffle and not self.test_mode:
                perm = self.rng.permutation(points.shape[0])
                points, pmask = points[perm], pmask[perm]
            sample.update(points=points, points_mask=pmask)
        if self.use_camera:
            sample.update(self._load_camera(info))
        if self.load_occ:
            sample['gt_occ'] = self._load_occ(info)
        if not self.test_mode:
            boxes, labels, mask = self._load_annotations(info)
            sample.update(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)
            if self.aug:
                sample = self._apply_aug(sample)
        return sample

    def _apply_aug(self, sample: Dict) -> Dict:
        """Training augmentations keeping GT / points / camera geometry
        consistent (reference pipeline modules cited per function), in
        the JAX package's order and ``self.rng`` consumption."""
        from omnihd_scenes_tpu_torch.data import augmentation as A

        aug = self.aug
        geom_dirty = False
        if aug.get('photometric') and 'imgs' in sample:
            # 'photometric': True -> per-sample draws (multi-view
            # consistent); 'per_view' -> the reference's per-view redraw.
            sample['imgs'] = A.photometric_distortion(
                sample['imgs'], self.rng,
                per_view=aug.get('photometric') == 'per_view')
        if aug.get('crop_resize_flip') and 'imgs' in sample:
            params = A.sample_crop_resize_flip(
                self.rng, aug['crop_resize_flip'],
                training=not self.test_mode)
            sample['imgs'], sample['lidar2img'] = \
                A.crop_resize_flip_images(sample['imgs'],
                                          sample['lidar2img'], *params)
            geom_dirty = True
        if aug.get('rot_scale_flip_image') is not None and \
                'lidar2img' in sample:
            vel_dims = (3, 5) if self.modality == 'radar' else None
            kw = dict(aug['rot_scale_flip_image']) \
                if isinstance(aug['rot_scale_flip_image'], dict) else {}
            boxes, l2i, pts, _ = A.global_rot_scale_trans_image(
                sample['gt_boxes'], sample['lidar2img'], self.rng,
                points=sample.get('points'), vel_dims=vel_dims, **kw)
            sample['gt_boxes'] = boxes
            sample['lidar2img'] = l2i
            if pts is not None:
                sample['points'] = pts
            geom_dirty = True
        if aug.get('rot_scale_flip') is not None and 'points' in sample \
                and 'imgs' not in sample:
            vel_dims = (3, 5) if self.modality == 'radar' else None
            kw = dict(aug['rot_scale_flip']) \
                if isinstance(aug['rot_scale_flip'], dict) else {}
            flip_ratio = kw.pop('flip_ratio', 0.5)
            pts, boxes, _, _ = A.global_rot_scale_trans(
                sample['points'], sample['gt_boxes'], self.rng,
                vel_dims=vel_dims, **kw)
            pts, boxes, _ = A.random_flip_3d(pts, boxes, self.rng,
                                             flip_ratio=flip_ratio,
                                             vel_dims=vel_dims)
            sample['points'] = pts.astype(np.float32)
            sample['gt_boxes'] = boxes.astype(np.float32)
        if geom_dirty and 'img2lidar_rots' in sample:
            inv = np.linalg.inv(sample['lidar2img'].astype(np.float64))
            sample['img2lidar_rots'] = inv[:, :3, :3].astype(np.float32)
            sample['img2lidar_trans'] = inv[:, :3, 3].astype(np.float32)
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
