"""Detection metric data model.

Parity target: ``newscenes_devkit/eval/detection/data_classes.py`` —
``DetectionConfig`` (per-class rectangular ranges, dist thresholds),
``DetectionMetricData`` (101-point interpolated PR + TP-error curves),
``DetectionMetrics`` (mAP, TP errors, NOS), ``DetectionBox`` (adds the
OmniHD camera-visibility flag) and ``DetectionMetricDataList``.

NOS (aka ODS in the README) = (mean_ap_weight * mAP
+ sum_m max(0, 1 - TPerr_m)) / (mean_ap_weight + #TP metrics)
(reference ``data_classes.py:265-276``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.eval.common import EvalBox, MetricData, center_distance
from omnihd_scenes_tpu_torch.eval.detection.constants import (ATTRIBUTE_NAMES,
                                                        DETECTION_NAMES,
                                                        TP_METRICS)


class DetectionConfig:
    """Evaluation settings for the detection task."""

    def __init__(self,
                 class_range: Dict[str, list],
                 dist_fcn: str,
                 dist_ths: List[float],
                 dist_th_tp: float,
                 min_recall: float,
                 min_precision: float,
                 max_boxes_per_sample: int,
                 mean_ap_weight: int):
        assert set(class_range.keys()) == set(DETECTION_NAMES), \
            "Class count mismatch."
        assert dist_th_tp in dist_ths, "dist_th_tp must be in set of dist_ths."

        self.class_range = class_range
        self.dist_fcn = dist_fcn
        self.dist_ths = dist_ths
        self.dist_th_tp = dist_th_tp
        self.min_recall = min_recall
        self.min_precision = min_precision
        self.max_boxes_per_sample = max_boxes_per_sample
        self.mean_ap_weight = mean_ap_weight
        self.class_names = self.class_range.keys()

    def __eq__(self, other):
        return all(np.array_equal(getattr(self, k), getattr(other, k))
                   for k in self.serialize().keys())

    def serialize(self) -> dict:
        return {
            'class_range': self.class_range,
            'dist_fcn': self.dist_fcn,
            'dist_ths': self.dist_ths,
            'dist_th_tp': self.dist_th_tp,
            'min_recall': self.min_recall,
            'min_precision': self.min_precision,
            'max_boxes_per_sample': self.max_boxes_per_sample,
            'mean_ap_weight': self.mean_ap_weight,
        }

    @classmethod
    def deserialize(cls, content: dict):
        return cls(content['class_range'], content['dist_fcn'],
                   content['dist_ths'], content['dist_th_tp'],
                   content['min_recall'], content['min_precision'],
                   content['max_boxes_per_sample'], content['mean_ap_weight'])

    @property
    def dist_fcn_callable(self):
        if self.dist_fcn == 'center_distance':
            return center_distance
        raise Exception(f'Unknown distance function {self.dist_fcn}!')


class DetectionMetricData(MetricData):
    """Accumulated + interpolated curves for one (class, dist_th) pair."""

    nelem = 101

    def __init__(self, recall, precision, confidence,
                 trans_err, vel_err, scale_err, orient_err):
        for arr in (recall, precision, confidence,
                    trans_err, vel_err, scale_err, orient_err):
            assert len(arr) == self.nelem
        assert all(confidence == sorted(confidence, reverse=True)), \
            "Confidences should be descending."
        assert all(recall == sorted(recall)), "Recalls should be ascending."

        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.trans_err = trans_err
        self.vel_err = vel_err
        self.scale_err = scale_err
        self.orient_err = orient_err

    def __eq__(self, other):
        return all(np.array_equal(getattr(self, k), getattr(other, k))
                   for k in self.serialize().keys())

    @property
    def max_recall_ind(self) -> int:
        """Index of max achieved recall = last confidence > 0."""
        non_zero = np.nonzero(self.confidence)[0]
        return int(non_zero[-1]) if len(non_zero) > 0 else 0

    @property
    def max_recall(self) -> float:
        return self.recall[self.max_recall_ind]

    def serialize(self):
        return {k: getattr(self, k).tolist()
                for k in ('recall', 'precision', 'confidence',
                          'trans_err', 'vel_err', 'scale_err', 'orient_err')}

    @classmethod
    def deserialize(cls, content: dict):
        return cls(**{k: np.array(content[k])
                      for k in ('recall', 'precision', 'confidence',
                                'trans_err', 'vel_err', 'scale_err',
                                'orient_err')})

    @classmethod
    def no_predictions(cls):
        return cls(recall=np.linspace(0, 1, cls.nelem),
                   precision=np.zeros(cls.nelem),
                   confidence=np.zeros(cls.nelem),
                   trans_err=np.ones(cls.nelem),
                   vel_err=np.ones(cls.nelem),
                   scale_err=np.ones(cls.nelem),
                   orient_err=np.ones(cls.nelem))

    @classmethod
    def random_md(cls, rng: np.random.RandomState = None):
        rng = rng or np.random
        return cls(recall=np.linspace(0, 1, cls.nelem),
                   precision=rng.random_sample(cls.nelem),
                   confidence=np.linspace(0, 1, cls.nelem)[::-1],
                   trans_err=rng.random_sample(cls.nelem),
                   vel_err=rng.random_sample(cls.nelem),
                   scale_err=rng.random_sample(cls.nelem),
                   orient_err=rng.random_sample(cls.nelem))


class DetectionMetrics:
    """AP / TP-error store with mAP + NOS summaries."""

    def __init__(self, cfg: DetectionConfig):
        self.cfg = cfg
        self._label_aps = defaultdict(lambda: defaultdict(float))
        self._label_tp_errors = defaultdict(lambda: defaultdict(float))
        self.eval_time = None

    def add_label_ap(self, detection_name: str, dist_th: float, ap: float) -> None:
        self._label_aps[detection_name][dist_th] = ap

    def get_label_ap(self, detection_name: str, dist_th: float) -> float:
        return self._label_aps[detection_name][dist_th]

    def add_label_tp(self, detection_name: str, metric_name: str, tp: float):
        self._label_tp_errors[detection_name][metric_name] = tp

    def get_label_tp(self, detection_name: str, metric_name: str) -> float:
        return self._label_tp_errors[detection_name][metric_name]

    def add_runtime(self, eval_time: float) -> None:
        self.eval_time = eval_time

    @property
    def mean_dist_aps(self) -> Dict[str, float]:
        return {name: float(np.mean(list(d.values())))
                for name, d in self._label_aps.items()}

    @property
    def mean_ap(self) -> float:
        return float(np.mean(list(self.mean_dist_aps.values())))

    @property
    def tp_errors(self) -> Dict[str, float]:
        errors = {}
        for metric_name in TP_METRICS:
            class_errors = [self.get_label_tp(name, metric_name)
                            for name in self.cfg.class_names]
            errors[metric_name] = float(np.nanmean(class_errors))
        return errors

    @property
    def tp_scores(self) -> Dict[str, float]:
        return {m: max(0.0, 1.0 - err) for m, err in self.tp_errors.items()}

    @property
    def no_score(self) -> float:
        """NewScenes Overall Score (NOS / "ODS")."""
        total = float(self.cfg.mean_ap_weight * self.mean_ap
                      + np.sum(list(self.tp_scores.values())))
        return total / float(self.cfg.mean_ap_weight + len(self.tp_scores))

    def serialize(self):
        return {
            'label_aps': self._label_aps,
            'mean_dist_aps': self.mean_dist_aps,
            'mean_ap': self.mean_ap,
            'label_tp_errors': self._label_tp_errors,
            'tp_errors': self.tp_errors,
            'tp_scores': self.tp_scores,
            'NOS': self.no_score,
            'eval_time': self.eval_time,
            'cfg': self.cfg.serialize(),
        }

    @classmethod
    def deserialize(cls, content: dict):
        metrics = cls(cfg=DetectionConfig.deserialize(content['cfg']))
        metrics.add_runtime(content['eval_time'])
        for name, label_aps in content['label_aps'].items():
            for dist_th, ap in label_aps.items():
                metrics.add_label_ap(name, float(dist_th), float(ap))
        for name, label_tps in content['label_tp_errors'].items():
            for metric_name, tp in label_tps.items():
                metrics.add_label_tp(name, metric_name, float(tp))
        return metrics

    def __eq__(self, other):
        return (self._label_aps == other._label_aps
                and self._label_tp_errors == other._label_tp_errors
                and self.eval_time == other.eval_time
                and self.cfg == other.cfg)


class DetectionBox(EvalBox):
    """Eval box with class name, score and OmniHD camera visibility."""

    def __init__(self,
                 sample_token: str = "",
                 translation: Tuple[float, float, float] = (0, 0, 0),
                 size: Tuple[float, float, float] = (0, 0, 0),
                 rotation: Tuple[float, float, float, float] = (0, 0, 0, 0),
                 velocity: Tuple[float, float] = (0, 0),
                 ego_translation: Tuple[float, float, float] = (0, 0, 0),
                 num_pts: int = -1,
                 detection_name: str = 'car',
                 detection_score: float = -1.0,
                 attribute_name: str = '',
                 visibility: bool = 1):
        super().__init__(sample_token, translation, size, rotation, velocity,
                         ego_translation, num_pts)
        assert detection_name is not None, 'detection_name cannot be empty!'
        assert detection_name in DETECTION_NAMES, \
            f'Unknown detection_name {detection_name}'
        assert attribute_name in ATTRIBUTE_NAMES or attribute_name == '', \
            f'Unknown attribute_name {attribute_name}'
        assert isinstance(detection_score, float), \
            'detection_score must be a float!'
        assert not np.any(np.isnan(detection_score)), \
            'detection_score may not be NaN!'

        self.detection_name = detection_name
        self.detection_score = detection_score
        self.attribute_name = attribute_name
        self.visibility = visibility

    def __eq__(self, other):
        return (self.sample_token == other.sample_token
                and self.translation == other.translation
                and self.size == other.size
                and self.rotation == other.rotation
                and self.velocity == other.velocity
                and self.ego_translation == other.ego_translation
                and self.num_pts == other.num_pts
                and self.detection_name == other.detection_name
                and self.detection_score == other.detection_score
                and self.attribute_name == other.attribute_name
                and self.visibility == other.visibility)

    def serialize(self) -> dict:
        return {
            'sample_token': self.sample_token,
            'translation': self.translation,
            'size': self.size,
            'rotation': self.rotation,
            'velocity': self.velocity,
            'ego_translation': self.ego_translation,
            'num_pts': self.num_pts,
            'detection_name': self.detection_name,
            'detection_score': self.detection_score,
            'attribute_name': self.attribute_name,
            'visibility': self.visibility,
        }

    @classmethod
    def deserialize(cls, content: dict):
        # Reference quirk kept for JSON-level parity: ego_translation is
        # read from 'translation' (data_classes.py:390).
        return cls(sample_token=content['sample_token'],
                   translation=tuple(content['translation']),
                   size=tuple(content['size']),
                   rotation=tuple(content['rotation']),
                   velocity=tuple(content['velocity']),
                   ego_translation=tuple(content['translation']),
                   num_pts=int(content.get('num_pts', -1)),
                   detection_name=content['detection_name'],
                   detection_score=float(content.get('detection_score', -1.0)),
                   attribute_name=content.get('attribute_name', ''),
                   visibility=content.get('visibility', 1))


class DetectionMetricDataList:
    """Dict of MetricData keyed by (class name, match distance)."""

    def __init__(self):
        self.md = {}

    def __getitem__(self, key):
        return self.md[key]

    def __eq__(self, other):
        return all(self[key] == other[key] for key in self.md.keys())

    def get_class_data(self, detection_name: str):
        return [(md, dist_th) for (name, dist_th), md in self.md.items()
                if name == detection_name]

    def get_dist_data(self, dist_th: float):
        return [(md, name) for (name, dist), md in self.md.items()
                if dist == dist_th]

    def set(self, detection_name: str, match_distance: float,
            data: DetectionMetricData):
        self.md[(detection_name, match_distance)] = data

    def serialize(self) -> dict:
        return {f'{key[0]}:{key[1]}': value.serialize()
                for key, value in self.md.items()}

    @classmethod
    def deserialize(cls, content: dict):
        mdl = cls()
        for key, md in content.items():
            name, distance = key.split(':')
            mdl.set(name, float(distance), DetectionMetricData.deserialize(md))
        return mdl
