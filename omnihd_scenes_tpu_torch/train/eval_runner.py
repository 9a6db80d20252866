"""Evaluation runner (counterpart of
``omnihd_scenes_tpu/train/eval_runner.py``), for the detection families:
batched inference over a dataset, then the devkit detection eval.  The
occupancy metrics and the streaming (BEVFormer) runners are not ported
yet (ROADMAP queue 1 items 5 and 6).
"""

from __future__ import annotations

from typing import Dict, List

from omnihd_scenes_tpu_torch.data.loader import EvalLoader


def run_inference_generic(predict_fn, model, dataset,
                          batch_size: int) -> Dict:
    """Batched inference -> {'bbox_results': per-sample detections in
    dataset order, 'occ_results': None}.  ``predict_fn(model, batch)``
    is :func:`train.builder.make_predict_fn_generic`'s."""
    results: List = [None] * len(dataset)
    for batch, valid in EvalLoader(dataset, batch_size):
        indices = batch.pop('index')
        dets = [t.cpu().numpy() for t in predict_fn(model, batch)]
        boxes, scores, labels, det_valid = dets
        for i, ok in enumerate(valid):
            if ok:
                results[int(indices[i])] = {
                    'boxes': boxes[i], 'scores': scores[i],
                    'labels': labels[i], 'valid': det_valid[i]}
    return {'bbox_results': results, 'occ_results': None}


def evaluate_results(dataset, outputs: Dict, dataroot: str, version: str,
                     eval_set: str, jsonfile_prefix: str,
                     verbose: bool = False) -> Dict[str, float]:
    """Detection metrics (mAP, NOS, TP errors, per-class AP) from
    inference outputs."""
    if outputs.get('occ_results') is not None:
        raise NotImplementedError('the occupancy eval is not ported yet '
                                  '(ROADMAP queue 1 item 3)')
    return dataset.evaluate(outputs['bbox_results'], dataroot=dataroot,
                            version=version, eval_set=eval_set,
                            jsonfile_prefix=jsonfile_prefix, verbose=verbose)
