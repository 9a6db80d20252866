"""Tracking eval data model (counterpart of
``omnihd_scenes_tpu/eval/tracking/data_classes.py``).

Parity target: ``newscenes_devkit/eval/tracking/data_classes.py``
(nuScenes-style): ``TrackingBox`` (tracking_id/name/score instead of
detection fields) and ``TrackingConfig``.  The reference suite is
vestigial/broken (imports a missing ``add_center_dist``, undefined vars
in the ``load_gt`` tracking branch — SURVEY.md §2.2); this is a
self-contained working implementation without the ``motmetrics``
dependency.
"""

from __future__ import annotations

from typing import Dict, Tuple

from omnihd_scenes_tpu_torch.eval.common import EvalBox

TRACKING_NAMES = ['car', 'pedestrian', 'rider', 'large_vehicle']

# Full reference metric name list (constants.py TRACKING_METRICS):
# averages + internals + the legacy motmetrics set.
AMOT_METRICS = ['amota', 'amotp']
LEGACY_METRICS = ['mota', 'motp', 'mt', 'ml', 'faf', 'tp', 'fp', 'fn',
                  'ids', 'frag', 'tid', 'lgd']
TRACKING_METRICS = AMOT_METRICS + ['recall'] + LEGACY_METRICS


class TrackingConfig:
    """Evaluation settings for the tracking task."""

    def __init__(self,
                 class_range: Dict[str, list] = None,
                 dist_fcn: str = 'center_distance',
                 dist_th_tp: float = 2.0,
                 min_recall: float = 0.1,
                 max_boxes_per_sample: int = 500,
                 nelem: int = 40):
        self.class_range = class_range or {c: [60, 40]
                                           for c in TRACKING_NAMES}
        self.tracking_names = list(self.class_range.keys())
        self.dist_fcn = dist_fcn
        self.dist_th_tp = dist_th_tp
        self.min_recall = min_recall
        self.max_boxes_per_sample = max_boxes_per_sample
        self.nelem = nelem   # recall thresholds for AMOTA/AMOTP

    def serialize(self) -> dict:
        return {'class_range': self.class_range, 'dist_fcn': self.dist_fcn,
                'dist_th_tp': self.dist_th_tp,
                'min_recall': self.min_recall,
                'max_boxes_per_sample': self.max_boxes_per_sample,
                'nelem': self.nelem}

    @classmethod
    def deserialize(cls, content: dict):
        return cls(**content)


class TrackingBox(EvalBox):
    """Eval box with tracking id/name/score."""

    def __init__(self,
                 sample_token: str = "",
                 translation: Tuple[float, float, float] = (0, 0, 0),
                 size: Tuple[float, float, float] = (1, 1, 1),
                 rotation: Tuple[float, float, float, float] = (1, 0, 0, 0),
                 velocity: Tuple[float, float] = (0, 0),
                 ego_translation: Tuple[float, float, float] = (0, 0, 0),
                 num_pts: int = -1,
                 tracking_id: str = '',
                 tracking_name: str = 'car',
                 tracking_score: float = -1.0,
                 visibility: int = 1):
        super().__init__(sample_token, translation, size, rotation, velocity,
                         ego_translation, num_pts)
        assert tracking_name in TRACKING_NAMES, tracking_name
        self.tracking_id = str(tracking_id)
        self.tracking_name = tracking_name
        self.tracking_score = float(tracking_score)
        self.visibility = visibility

    def serialize(self) -> dict:
        return {
            'sample_token': self.sample_token,
            'translation': self.translation,
            'size': self.size,
            'rotation': self.rotation,
            'velocity': self.velocity,
            'ego_translation': self.ego_translation,
            'num_pts': self.num_pts,
            'tracking_id': self.tracking_id,
            'tracking_name': self.tracking_name,
            'tracking_score': self.tracking_score,
            'visibility': self.visibility,
        }

    @classmethod
    def deserialize(cls, content: dict):
        return cls(sample_token=content['sample_token'],
                   translation=tuple(content['translation']),
                   size=tuple(content['size']),
                   rotation=tuple(content['rotation']),
                   velocity=tuple(content.get('velocity', (0, 0))),
                   ego_translation=tuple(content['translation']),
                   num_pts=int(content.get('num_pts', -1)),
                   tracking_id=content['tracking_id'],
                   tracking_name=content['tracking_name'],
                   tracking_score=float(content.get('tracking_score', -1.0)),
                   visibility=content.get('visibility', 1))
