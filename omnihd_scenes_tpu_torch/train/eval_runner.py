"""Evaluation runner (counterpart of
``omnihd_scenes_tpu/train/eval_runner.py``) for the anchor families:
batched inference over a dataset, then the devkit detection eval and,
for BEVFusion-OCC, the occupancy eval (reference
``apis/od_occ_mtl_test.py:30-110``).  The streaming (BEVFormer) runners
are not ported yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from omnihd_scenes_tpu_torch.data.loader import EvalLoader
from omnihd_scenes_tpu_torch.eval.occupancy import (evaluation_semantic,
                                                    summarize_occ_scores)


def run_inference_generic(predict_fn, model, dataset,
                          batch_size: int) -> Dict:
    """Batched inference -> {'bbox_results': per-sample detections in
    dataset order, 'occ_results': per-sample occupancy argmax grids, or
    None when the model predicts none}.  ``predict_fn(model, batch)`` is
    :func:`train.builder.make_predict_fn_generic`'s."""
    results: List = [None] * len(dataset)
    occ_results: List = [None] * len(dataset)
    for batch, valid in EvalLoader(dataset, batch_size):
        indices = batch.pop('index')
        dets, occ_pred = predict_fn(model, batch)
        boxes, scores, labels, det_valid = [t.cpu().numpy() for t in dets]
        if occ_pred is not None:
            occ_pred = occ_pred.cpu().numpy()
        for i, ok in enumerate(valid):
            if ok:
                results[int(indices[i])] = {
                    'boxes': boxes[i], 'scores': scores[i],
                    'labels': labels[i], 'valid': det_valid[i]}
                if occ_pred is not None:
                    occ_results[int(indices[i])] = occ_pred[i]
    return {'bbox_results': results,
            'occ_results': occ_results if occ_results[0] is not None
            else None}


def bad_condition_scenes(dataset, dataroot: str, version: str) -> set:
    """The tokens of the dataset's rainy or night scenes (reference
    ``od_occ_mtl_test.py:56-71``)."""
    from omnihd_scenes_tpu_torch.devkit.database import NewScenes

    newsc = NewScenes(version=version, dataroot=dataroot, verbose=False)
    bad = set()
    for scene in {i['scene_token'] for i in dataset.infos}:
        meta = newsc.get('meta', scene)['meta']
        if meta['weather'] == 'rainy' or meta['lighting'] == 'night':
            bad.add(scene)
    return bad


def evaluate_results(dataset, outputs: Dict, dataroot: str, version: str,
                     eval_set: str, jsonfile_prefix: str,
                     occ_class_names=None,
                     bad_conditions: bool = False,
                     verbose: bool = False) -> Dict[str, float]:
    """Detection (+ occupancy) metrics from inference outputs.

    ``bad_conditions`` restricts both tasks to rainy / night scenes.  The
    occupancy metrics are ``occ_<name>`` for the geometric IoU, each
    class (``cls_<i>`` unless ``occ_class_names``) and the mIoU; the
    class count is one more than the largest label of the first sample's
    prediction and GT, as in JAX.
    """
    bad_ok = (bad_condition_scenes(dataset, dataroot, version)
              if bad_conditions else None)
    metrics = dataset.evaluate(outputs['bbox_results'], dataroot=dataroot,
                               version=version, eval_set=eval_set,
                               jsonfile_prefix=jsonfile_prefix,
                               bad_conditions=bad_conditions,
                               verbose=verbose)
    if outputs.get('occ_results'):
        scores = []
        n_cls = None
        for idx, occ_pred in enumerate(outputs['occ_results']):
            if bad_ok is not None \
                    and dataset.infos[idx]['scene_token'] not in bad_ok:
                continue
            gt = dataset._load_occ(dataset.infos[idx])
            if n_cls is None:
                n_cls = int(max(occ_pred.max(), gt.max())) + 1
            scores.append(evaluation_semantic(np.asarray(occ_pred), gt,
                                              n_cls))
        if scores:
            occ_summary = summarize_occ_scores(
                scores, occ_class_names
                or [f'cls_{i}' for i in range(1, n_cls)])
            metrics.update({f'occ_{k}': v for k, v in occ_summary.items()})
    return metrics
