"""Shared evaluation primitives: eval boxes, distances, loaders.

Parity targets in the reference:
- ``newscenes_devkit/eval/common/data_classes.py`` (EvalBox / EvalBoxes)
- ``newscenes_devkit/eval/common/utils.py`` (distance & error functions)
- ``newscenes_devkit/eval/common/loaders.py`` (prediction/GT loading and
  the OmniHD rectangular-range + camera-visibility filters)

Everything is float64 NumPy so existing result JSONs score identically.
"""

from __future__ import annotations

import abc
import json
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion


# ---------------------------------------------------------------------------
# Box containers
# ---------------------------------------------------------------------------

class EvalBox(abc.ABC):
    """Base class for boxes used during evaluation (prediction or GT)."""

    def __init__(self,
                 sample_token: str = "",
                 translation: Tuple[float, float, float] = (0, 0, 0),
                 size: Tuple[float, float, float] = (0, 0, 0),
                 rotation: Tuple[float, float, float, float] = (0, 0, 0, 0),
                 velocity: Tuple[float, float] = (0, 0),
                 ego_translation: Tuple[float, float, float] = (0, 0, 0),
                 num_pts: int = -1):
        assert isinstance(sample_token, str), 'sample_token must be a string!'
        assert len(translation) == 3 and not np.any(np.isnan(translation))
        assert len(size) == 3 and not np.any(np.isnan(size))
        assert len(rotation) == 4 and not np.any(np.isnan(rotation))
        assert len(velocity) == 2  # velocity may be NaN
        assert len(ego_translation) == 3 and not np.any(np.isnan(ego_translation))
        assert isinstance(num_pts, int)

        self.sample_token = sample_token
        self.translation = translation
        self.size = size
        self.rotation = rotation
        self.velocity = velocity
        self.ego_translation = ego_translation
        self.num_pts = num_pts

    @property
    def ego_dist(self) -> float:
        return float(np.sqrt(np.sum(np.array(self.ego_translation[:2]) ** 2)))

    def __repr__(self):
        return str(self.serialize())

    @abc.abstractmethod
    def serialize(self) -> dict:
        ...

    @classmethod
    @abc.abstractmethod
    def deserialize(cls, content: dict):
        ...


class EvalBoxes:
    """Groups EvalBox instances by sample token."""

    def __init__(self):
        self.boxes = defaultdict(list)

    def __repr__(self):
        return (f"EvalBoxes with {len(self.all)} boxes across "
                f"{len(self.sample_tokens)} samples")

    def __getitem__(self, item) -> List[EvalBox]:
        return self.boxes[item]

    def __eq__(self, other):
        if set(self.sample_tokens) != set(other.sample_tokens):
            return False
        for token in self.sample_tokens:
            if len(self[token]) != len(other[token]):
                return False
            if any(b1 != b2 for b1, b2 in zip(self[token], other[token])):
                return False
        return True

    def __len__(self):
        return len(self.boxes)

    @property
    def all(self) -> List[EvalBox]:
        out = []
        for token in self.sample_tokens:
            out.extend(self[token])
        return out

    @property
    def sample_tokens(self) -> List[str]:
        return list(self.boxes.keys())

    def add_boxes(self, sample_token: str, boxes: List[EvalBox]) -> None:
        self.boxes[sample_token].extend(boxes)

    def serialize(self) -> dict:
        return {key: [box.serialize() for box in boxes]
                for key, boxes in self.boxes.items()}

    @classmethod
    def deserialize(cls, content: dict, box_cls):
        eb = cls()
        for sample_token, boxes in content.items():
            eb.add_boxes(sample_token, [box_cls.deserialize(b) for b in boxes])
        return eb


class MetricData(abc.ABC):
    """Base class for task-specific accumulated metric data."""

    @abc.abstractmethod
    def serialize(self):
        ...

    @classmethod
    @abc.abstractmethod
    def deserialize(cls, content: dict):
        ...


# ---------------------------------------------------------------------------
# Distance / error functions
# ---------------------------------------------------------------------------

def center_distance(gt_box: EvalBox, pred_box: EvalBox) -> float:
    """L2 distance between box centers, xy only."""
    return float(np.linalg.norm(
        np.array(pred_box.translation[:2]) - np.array(gt_box.translation[:2])))


def velocity_l2(gt_box: EvalBox, pred_box: EvalBox) -> float:
    """L2 distance between xy velocity vectors (NaN -> inf, clipped later)."""
    return float(np.linalg.norm(
        np.array(pred_box.velocity) - np.array(gt_box.velocity)))


def angle_diff(x: float, y: float, period: float) -> float:
    """Smallest signed angle from y to x modulo ``period``, in (-pi, pi]."""
    diff = (x - y + period / 2) % period - period / 2
    if diff > np.pi:
        diff = diff - (2 * np.pi)
    return diff


def yaw_diff(gt_box: EvalBox, eval_box: EvalBox, period: float = 2 * np.pi) -> float:
    """Absolute yaw difference between two boxes in [0, pi]."""
    yaw_gt = quaternion_yaw(Quaternion(gt_box.rotation))
    yaw_est = quaternion_yaw(Quaternion(eval_box.rotation))
    return abs(angle_diff(yaw_gt, yaw_est, period))


def scale_iou(sample_annotation: EvalBox, sample_result: EvalBox) -> float:
    """3D IoU assuming aligned translation/rotation (size-only IoU)."""
    sa = np.array(sample_annotation.size)
    sr = np.array(sample_result.size)
    assert np.all(sa > 0), 'sample_annotation sizes must be >0.'
    assert np.all(sr > 0), 'sample_result sizes must be >0.'
    inter = float(np.prod(np.minimum(sa, sr)))
    union = float(np.prod(sa)) + float(np.prod(sr)) - inter
    return inter / union


def quaternion_yaw(q: Quaternion) -> float:
    """Yaw of a quaternion representing a box in lidar/global frame."""
    v = q.rotation_matrix @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def cummean(x: np.ndarray) -> np.ndarray:
    """NaN-aware cumulative mean; all-NaN input returns all-ones."""
    if np.sum(np.isnan(x)) == len(x):
        return np.ones(len(x))
    sums = np.nancumsum(x.astype(float))
    counts = np.cumsum(~np.isnan(x))
    return np.divide(sums, counts, out=np.zeros_like(sums), where=counts != 0)


def boxes_to_sensor(boxes: List[EvalBox], pose_record: Dict, cs_record: Dict):
    """Map eval boxes from global coordinates into a sensor frame."""
    from omnihd_scenes_tpu_torch.devkit.boxes import Box

    out = []
    for box in boxes:
        b = Box(list(box.translation), list(box.size), Quaternion(box.rotation))
        b.translate(-np.array(pose_record['translation']))
        b.rotate(Quaternion(pose_record['rotation']).inverse)
        b.translate(-np.array(cs_record['translation']))
        b.rotate(Quaternion(cs_record['rotation']).inverse)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# Loaders & filters
# ---------------------------------------------------------------------------

def load_prediction(result_path: str, max_boxes_per_sample: int, box_cls,
                    verbose: bool = False) -> Tuple[EvalBoxes, Dict]:
    """Load a result JSON ({'meta':..., 'results': {token: [boxes]}})."""
    with open(result_path) as f:
        data = json.load(f)
    assert 'results' in data, \
        'No field `results` in result file; the result format changed.'

    all_results = EvalBoxes.deserialize(data['results'], box_cls)
    meta = data['meta']
    if verbose:
        print(f"Loaded results from {result_path}. Found detections for "
              f"{len(all_results.sample_tokens)} samples.")

    for sample_token in all_results.sample_tokens:
        assert len(all_results.boxes[sample_token]) <= max_boxes_per_sample, \
            f"Only <= {max_boxes_per_sample} boxes per sample allowed!"
    return all_results, meta


def load_gt(newsc, eval_split: str, box_cls, verbose: bool = False) -> EvalBoxes:
    """Load GT boxes for a split straight from the database."""
    from omnihd_scenes_tpu_torch.eval.detection.data_classes import DetectionBox
    from omnihd_scenes_tpu_torch.eval.detection.utils import category_to_detection_name

    if verbose:
        print(f'Loading annotations for {eval_split} split from NewScenes '
              f'version: {newsc.version}')

    sample_tokens_all = [s['token'] for s in newsc.sample]
    assert len(sample_tokens_all) > 0, "Database has no samples!"

    splits = newsc.scene_split
    version = newsc.version
    if eval_split in {'train', 'val', 'train_detect', 'train_track'}:
        assert version.endswith('trainval'), \
            f'Split {eval_split} incompatible with version {version}'
    elif eval_split in {'train_mini', 'val_mini'}:
        assert version.endswith('mini'), \
            f'Split {eval_split} incompatible with version {version}'
    elif eval_split == 'test':
        assert version.endswith('test'), \
            f'Split {eval_split} incompatible with version {version}'
    else:
        raise ValueError(f'Cannot map split {eval_split} to a NewScenes version.')

    sample_tokens = [t for t in sample_tokens_all
                     if newsc.get('sample', t)['scene_token'] in splits[eval_split]]

    all_annotations = EvalBoxes()
    for sample_token in sample_tokens:
        gt_boxes = newsc.get_annotation_box(sample_token)
        sample_boxes = []
        for box in gt_boxes:
            if box_cls is not DetectionBox:
                raise NotImplementedError(f'Invalid box_cls {box_cls}!')
            detection_name = category_to_detection_name(box.name)
            if detection_name is None:
                continue
            sample_boxes.append(box_cls(
                sample_token=sample_token,
                translation=tuple(box.center.tolist()),
                size=tuple(box.wlh.tolist()),
                rotation=tuple(box.orientation.elements.tolist()),
                velocity=tuple(box.velocity[:2].tolist()),
                ego_translation=tuple(box.center.tolist()),
                num_pts=-1,
                detection_name=detection_name,
                detection_score=-1.0,
                attribute_name='',
                visibility=box.visibility,
            ))
        all_annotations.add_boxes(sample_token, sample_boxes)

    if verbose:
        print(f"Loaded ground truth annotations for "
              f"{len(all_annotations.sample_tokens)} samples.")
    return all_annotations


def filter_eval_boxes(newsc, eval_boxes: EvalBoxes, max_dist: Dict[str, list],
                      verbose: bool = False,
                      bad_conditions: bool = False) -> EvalBoxes:
    """OmniHD eval filters, applied in place.

    1. Rectangular range: |x| <= max_dist[class][0] and |y| <= max_dist[class][1]
       in the ego frame (reference ``loaders.py:197-199``).
    2. Camera visibility == 1 (reference ``loaders.py:203``).
    3. Optional rainy/night-only slice via scene ``meta``
       (reference ``loaders.py:212-223``).
    """
    class_field = _get_box_class_field(eval_boxes)

    total, dist_filter, visibility_filter = 0, 0, 0
    for sample_token in eval_boxes.sample_tokens:
        total += len(eval_boxes[sample_token])
        eval_boxes.boxes[sample_token] = [
            box for box in eval_boxes[sample_token]
            if abs(box.ego_translation[0]) <= max_dist[getattr(box, class_field)][0]
            and abs(box.ego_translation[1]) <= max_dist[getattr(box, class_field)][1]]
        dist_filter += len(eval_boxes[sample_token])

        eval_boxes.boxes[sample_token] = [
            box for box in eval_boxes[sample_token] if box.visibility == 1]
        visibility_filter += len(eval_boxes[sample_token])

    if verbose:
        print(f"=> Original number of boxes: {total}")
        print(f"=> After distance based filtering: {dist_filter}")
        print(f"=> After Camera visibility based filtering: {visibility_filter}")

    if bad_conditions:
        for sample_token in list(eval_boxes.sample_tokens):
            scene_token = newsc.get('sample', sample_token)['scene_token']
            scene_meta = newsc.get('meta', scene_token)['meta']
            if not (scene_meta['weather'] == 'rainy'
                    or scene_meta['lighting'] == 'night'):
                del eval_boxes.boxes[sample_token]
        print("=> After Bad conditions based filtering: ", len(eval_boxes.all))

    return eval_boxes


def _get_box_class_field(eval_boxes: EvalBoxes) -> str:
    """'detection_name' or 'tracking_name' depending on the box type."""
    from omnihd_scenes_tpu_torch.eval.detection.data_classes import DetectionBox

    assert len(eval_boxes.boxes) > 0
    box = None
    for val in eval_boxes.boxes.values():
        if len(val) > 0:
            box = val[0]
            break
    if box is None:
        # No boxes at all (e.g. an empty submission): nothing to filter,
        # class field is irrelevant.  The reference raises here; we keep
        # empty-result evaluation well-defined (scores 0).
        return 'detection_name'
    if isinstance(box, DetectionBox):
        return 'detection_name'
    if hasattr(box, 'tracking_name'):
        return 'tracking_name'
    raise Exception(f'Invalid box type: {box}')
