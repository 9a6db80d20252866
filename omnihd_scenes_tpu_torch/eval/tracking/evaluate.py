"""Tracking evaluation (AMOTA/AMOTP per class; counterpart of
``omnihd_scenes_tpu/eval/tracking/evaluate.py``).

Parity target: ``newscenes_devkit/eval/tracking/evaluate.py``
(``TrackingEval``) — loads a tracking submission JSON
({'results': {token: [boxes w/ tracking_id]}}), builds GT tracks from
the database annotation track ids, groups frames per scene in temporal
order, and reports per-class + average AMOTA/AMOTP/MOTA/MOTP.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from omnihd_scenes_tpu_torch.eval.detection.utils import (
    category_to_detection_name)
from omnihd_scenes_tpu_torch.eval.tracking.algo import (accumulate_curve,
                                                        summarize_curve)
from omnihd_scenes_tpu_torch.eval.tracking.data_classes import (
    TrackingBox, TrackingConfig)
from omnihd_scenes_tpu_torch.eval.tracking.render import (
    _plt, render_tracking_curves)


def load_tracking_gt(newsc, eval_split: str) -> Dict[str, List[TrackingBox]]:
    """GT tracking boxes keyed by sample token."""
    splits = newsc.scene_split
    out = {}
    for s in newsc.sample:
        if s['scene_token'] not in splits[eval_split]:
            continue
        boxes = []
        for box in newsc.get_annotation_box(s['token']):
            name = category_to_detection_name(box.name)
            if name is None:
                continue
            boxes.append(TrackingBox(
                sample_token=s['token'],
                translation=tuple(box.center.tolist()),
                size=tuple(box.wlh.tolist()),
                rotation=tuple(box.orientation.elements.tolist()),
                ego_translation=tuple(box.center.tolist()),
                tracking_id=str(box.track_id),
                tracking_name=name,
                tracking_score=-1.0,
                visibility=box.visibility))
        out[s['token']] = boxes
    return out


class TrackingEval:
    """Scene-ordered AMOTA/AMOTP evaluation."""

    def __init__(self, newsc, config: TrackingConfig, result_path: str,
                 eval_set: str, output_dir: str = None,
                 verbose: bool = True):
        self.newsc = newsc
        self.cfg = config
        self.eval_set = eval_set
        self.output_dir = output_dir
        self.verbose = verbose

        with open(result_path) as f:
            data = json.load(f)
        self.pred = {tok: [TrackingBox.deserialize(b) for b in boxes]
                     for tok, boxes in data['results'].items()}
        self.gt = load_tracking_gt(newsc, eval_set)

        # Range + visibility filters (same policy as detection).
        for store in (self.pred, self.gt):
            for tok in store:
                store[tok] = [
                    b for b in store[tok]
                    if abs(b.ego_translation[0])
                    <= self.cfg.class_range[b.tracking_name][0]
                    and abs(b.ego_translation[1])
                    <= self.cfg.class_range[b.tracking_name][1]
                    and b.visibility == 1]

    def _scene_frames(self):
        """Sample tokens grouped per scene, time ordered."""
        per_scene = defaultdict(list)
        for s in self.newsc.sample:
            if s['token'] in self.gt:
                per_scene[s['scene_token']].append(s['token'])
        for scene in per_scene:
            per_scene[scene].sort(key=int)
        return per_scene

    def main(self, render_curves: bool = True) -> Dict[str, float]:
        if render_curves and self.output_dir:
            _plt()  # without matplotlib, fail before evaluating
        per_scene = self._scene_frames()
        # Real sample timestamps (token = microseconds, database.py) so
        # TID/LGD are measured in actual elapsed seconds, not an assumed
        # fixed keyframe period.
        sample_ts = {s['token']: s.get('timestamp', int(s['token'])) / 1e6
                     for s in self.newsc.sample}
        metrics = {}
        per_class = defaultdict(list)
        md_per_class = {}
        scene_times = [[sample_ts[tok] for tok in tokens]
                       for tokens in per_scene.values()]
        for cls in self.cfg.tracking_names:
            gt_scenes, pred_scenes = [], []
            for scene, tokens in per_scene.items():
                gt_scenes.append(
                    [[b for b in self.gt.get(tok, [])
                      if b.tracking_name == cls] for tok in tokens])
                pred_scenes.append(
                    [[b for b in self.pred.get(tok, [])
                      if b.tracking_name == cls] for tok in tokens])
            md = accumulate_curve(gt_scenes, pred_scenes,
                                  self.cfg.dist_th_tp,
                                  nelem=self.cfg.nelem,
                                  min_recall=self.cfg.min_recall,
                                  scene_times=scene_times)
            md_per_class[cls] = md
            res = summarize_curve(md, self.cfg.dist_th_tp)
            for k, v in res.items():
                metrics[f'{cls}_{k}'] = v
                per_class[k].append(v)

        for k, vals in per_class.items():
            metrics[k] = float(np.nanmean(vals))

        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir,
                                   'tracking_metrics.json'), 'w') as f:
                json.dump(metrics, f, indent=2)
            with open(os.path.join(self.output_dir,
                                   'tracking_details.json'), 'w') as f:
                json.dump({cls: {k: np.asarray(v).tolist()
                                 for k, v in md.items()}
                           for cls, md in md_per_class.items()}, f)
            if render_curves:
                render_tracking_curves(md_per_class, self.output_dir)
        if self.verbose:
            print(f"AMOTA: {metrics['amota']:.4f}  "
                  f"AMOTP: {metrics['amotp']:.4f}  "
                  f"MOTA: {metrics['mota']:.4f}  "
                  f"MT: {metrics['mt']:.0f}  ML: {metrics['ml']:.0f}  "
                  f"FRAG: {metrics['frag']:.0f}  "
                  f"TID: {metrics['tid']:.2f}s  "
                  f"LGD: {metrics['lgd']:.2f}s")
        return metrics
