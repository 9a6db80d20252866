"""Semantic occupancy evaluation: per-class IoU + mIoU.

Parity targets:
- ``aug_evaluation_semantic``
  (reference ``datasets/evaluation_metrics.py:98-118``): per-sample
  (class_num, 3) score matrix [TP, gt_count, pred_count]; row 0 is the
  geometric (occupied-vs-free) IoU;
- ``NewScenesOccDataset.evaluate``
  (``datasets/newscenes_occ_dataset.py:198-218``): score matrices are
  averaged over samples first, IoU = tp / (p + g - tp), mIoU = mean over
  semantic rows.

Restated from ``omnihd_scenes_tpu/eval/occupancy.py`` (host NumPy) so the
port imports nothing of the JAX package; ``tests/test_torch_port_occ.py``
holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

OCC_CLASS_NAMES = ['car', 'pedestrian', 'rider', 'large_vehicle', 'cycle',
                   'road_obstacle', 'traffic_fence', 'driveable_surface',
                   'sidewalk', 'vegetation', 'manmade']


def evaluation_semantic(pred_occ: np.ndarray, gt_occ: np.ndarray,
                        class_num: int) -> np.ndarray:
    """(class_num, 3) [TP, G, P] score matrix for one sample.

    pred_occ/gt_occ: (Dx, Dy, Dz) integer class grids, 0 = free.
    """
    score = np.zeros((class_num, 3))
    score[0, 0] = ((gt_occ != 0) & (pred_occ != 0)).sum()
    score[0, 1] = (gt_occ != 0).sum()
    score[0, 2] = (pred_occ != 0).sum()
    for j in range(1, class_num):
        score[j, 0] = ((gt_occ == j) & (pred_occ == j)).sum()
        score[j, 1] = (gt_occ == j).sum()
        score[j, 2] = (pred_occ == j).sum()
    return score


def summarize_occ_scores(scores: List[np.ndarray],
                         class_names: Sequence[str] = OCC_CLASS_NAMES
                         ) -> Dict[str, float]:
    """Average per-sample score matrices -> IoU dict + mIoU."""
    mat = np.stack(scores, axis=0).mean(0)
    class_num = mat.shape[0]
    names = {0: 'IoU'}
    for i, name in enumerate(class_names):
        names[i + 1] = name

    out = {}
    ious = []
    for i in range(class_num):
        tp, g, p = mat[i]
        union = p + g - tp
        iou = tp / union if union > 0 else float('nan')
        ious.append(iou)
        out[names.get(i, f'class_{i}')] = iou
    out['mIoU'] = float(np.nanmean(np.asarray(ious)[1:]))
    return out
