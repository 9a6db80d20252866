"""Detection matching algorithm: greedy PR accumulation, AP, TP errors.

Parity target: ``newscenes_devkit/eval/detection/algo.py``.  The
semantics reproduced exactly:

- predictions of a class are visited in descending confidence order,
  ties broken by *larger original index first* (the reference builds the
  order via ``sorted((conf, idx))`` then reverses);
- each prediction greedily takes the closest unmatched GT of the class
  in its sample (first index wins on exact distance ties, strict ``<``);
- a match requires distance strictly below the threshold;
- precision/confidence/TP-error curves are interpolated onto 101
  evenly-spaced recall points; TP-error curves are NaN-aware cumulative
  means interpolated on the confidence axis.

The per-prediction inner loop is vectorized over the sample's GT boxes
(same result as the reference's Python loop, ~50x faster on CPU).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from omnihd_scenes_tpu_torch.eval.common import (EvalBoxes, center_distance, cummean,
                                           scale_iou, velocity_l2, yaw_diff)
from omnihd_scenes_tpu_torch.eval.detection.data_classes import DetectionMetricData


def accumulate(gt_boxes: EvalBoxes,
               pred_boxes: EvalBoxes,
               class_name: str,
               dist_fcn: Callable,
               dist_th: float,
               verbose: bool = True) -> DetectionMetricData:
    """PR + TP-error accumulation for one class at one distance threshold."""
    npos = sum(1 for gt in gt_boxes.all if gt.detection_name == class_name)
    if verbose:
        print(f"Found {npos} GT of class {class_name} out of "
              f"{len(gt_boxes.all)} total across "
              f"{len(gt_boxes.sample_tokens)} samples.")

    if npos == 0:
        return DetectionMetricData.no_predictions()

    preds = [box for box in pred_boxes.all if box.detection_name == class_name]
    pred_confs = [box.detection_score for box in preds]
    if verbose:
        print(f"Found {len(pred_confs)} PRED of class {class_name} out of "
              f"{len(pred_boxes.all)} total across "
              f"{len(pred_boxes.sample_tokens)} samples.")

    # Descending confidence; equal confidences visit the later index first
    # (matches the reference's sorted((v, i)) + reverse).
    sortind = [i for (v, i) in sorted((v, i) for (i, v) in enumerate(pred_confs))][::-1]

    # Per-sample GT caches for the vectorized inner loop: class-filtered
    # (original gt_idx, xy-center) arrays plus a taken mask.
    gt_cache = {}
    for sample_token in gt_boxes.sample_tokens:
        idxs, centers = [], []
        for gt_idx, gt in enumerate(gt_boxes[sample_token]):
            if gt.detection_name == class_name:
                idxs.append(gt_idx)
                centers.append(gt.translation[:2])
        gt_cache[sample_token] = {
            'idxs': np.array(idxs, dtype=np.int64),
            'centers': np.array(centers, dtype=np.float64).reshape(-1, 2),
            'taken': np.zeros(len(idxs), dtype=bool),
        }

    use_center = dist_fcn is center_distance

    tp, fp, conf = [], [], []
    match_data = {'trans_err': [], 'vel_err': [], 'scale_err': [],
                  'orient_err': [], 'conf': []}

    for ind in sortind:
        pred_box = preds[ind]
        cache = gt_cache.get(pred_box.sample_token)

        min_dist = np.inf
        match_gt_idx = None
        if cache is not None and len(cache['idxs']) > 0:
            if use_center:
                d = np.linalg.norm(
                    cache['centers'] - np.asarray(pred_box.translation[:2]), axis=1)
            else:
                gts = gt_boxes[pred_box.sample_token]
                d = np.array([dist_fcn(gts[i], pred_box) for i in cache['idxs']])
            d = np.where(cache['taken'], np.inf, d)
            j = int(np.argmin(d))  # first minimal index, as in the reference loop
            if d[j] < min_dist:
                min_dist = float(d[j])
                match_gt_idx = int(cache['idxs'][j])

        if min_dist < dist_th:
            cache['taken'][np.searchsorted(cache['idxs'], match_gt_idx)] = True
            tp.append(1)
            fp.append(0)
            conf.append(pred_box.detection_score)

            gt_match = gt_boxes[pred_box.sample_token][match_gt_idx]
            match_data['trans_err'].append(center_distance(gt_match, pred_box))
            match_data['vel_err'].append(velocity_l2(gt_match, pred_box))
            match_data['scale_err'].append(1 - scale_iou(gt_match, pred_box))
            match_data['orient_err'].append(
                yaw_diff(gt_match, pred_box, period=2 * np.pi))
            match_data['conf'].append(pred_box.detection_score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(pred_box.detection_score)

    if len(match_data['trans_err']) == 0:
        return DetectionMetricData.no_predictions()

    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.array(conf)

    prec = tp / (fp + tp)
    rec = tp / float(npos)

    rec_interp = np.linspace(0, 1, DetectionMetricData.nelem)
    prec = np.interp(rec_interp, rec, prec, right=0)
    conf = np.interp(rec_interp, rec, conf, right=0)
    rec = rec_interp

    for key in match_data.keys():
        if key == 'conf':
            continue
        tmp = cummean(np.array(match_data[key]))
        match_data[key] = np.interp(conf[::-1], match_data['conf'][::-1],
                                    tmp[::-1])[::-1]

    return DetectionMetricData(recall=rec,
                               precision=prec,
                               confidence=conf,
                               trans_err=match_data['trans_err'],
                               vel_err=match_data['vel_err'],
                               scale_err=match_data['scale_err'],
                               orient_err=match_data['orient_err'])


def calc_ap(md: DetectionMetricData, min_recall: float,
            min_precision: float) -> float:
    """AP = mean precision above (min_recall, min_precision), renormalized."""
    assert 0 <= min_precision < 1
    assert 0 <= min_recall <= 1

    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: DetectionMetricData, min_recall: float, metric_name: str) -> float:
    """Mean TP error between min recall and max achieved recall."""
    first_ind = round(100 * min_recall) + 1
    last_ind = md.max_recall_ind
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(getattr(md, metric_name)[first_ind: last_ind + 1]))
