"""Evaluation runners (counterpart of
``omnihd_scenes_tpu/train/eval_runner.py``): batched inference over a
dataset for the anchor families, the streaming (temporal) inference of
BEVFormer, one stream or B scene-parallel streams (reference
``bevformer.py:270-306``), then the devkit detection eval and, for
BEVFusion-OCC, the occupancy eval (reference
``apis/od_occ_mtl_test.py:30-110``).

The streaming runners keep each stream's previous BEV where the predict
function leaves it (on the card for the port's); they read back only the
decoded boxes.  A batch of a device-decode dataset (``image_decode=
'device'``) is decoded on the model's device by ``image_loading.
decode_camera_batch`` before the predict function sees it; the detections
come back to the host in one copy a batch (:func:`detections_to_host`).
Both runners take an optional ``timer`` (``tools/benchmark.py``'s
``StageTimer``): ``timer.mark(stage)`` as each stage of a batch starts
(``'load'``, ``'upload'``, ``'decode'``, ``'model'``, then ``'end'``
before the batch's one host sync) and ``timer.batch_done(n_samples)``
after it, which ends the run early when it returns True.
The JAX package's probe of its windowed TSA dual is not ported: the port
computes the gather form, which has no window to overflow.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from omnihd_scenes_tpu_torch.data.image_loading import (HOST_KEYS,
                                                        JPEG_BYTES,
                                                        decode_camera_batch)
from omnihd_scenes_tpu_torch.data.loader import EvalLoader, collate
from omnihd_scenes_tpu_torch.data.temporal_dataset import StreamingEvalState
from omnihd_scenes_tpu_torch.eval.occupancy import (evaluation_semantic,
                                                    summarize_occ_scores)
from omnihd_scenes_tpu_torch.parallel import distributed
from omnihd_scenes_tpu_torch.parallel import mesh as dp
from omnihd_scenes_tpu_torch.train.loop import batch_to


class _Untimed:
    def mark(self, stage: str) -> None:
        pass

    def batch_done(self, n_samples: int) -> bool:
        return False


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def detections_to_host(dets) -> tuple:
    """(boxes, scores, labels, valid) as NumPy arrays, copied from the
    card in one transfer (one host sync): the four packed into one f32
    tensor (the labels and the flags are small integers, exact in f32)."""
    boxes, scores, labels, valid = dets
    if not (torch.is_tensor(boxes) and boxes.is_cuda):
        return tuple(np.asarray(t.cpu() if torch.is_tensor(t) else t)
                     for t in dets)
    packed = torch.cat([boxes.float(), scores.float()[..., None],
                        labels.float()[..., None], valid.float()[..., None]],
                       -1).cpu().numpy()
    d = boxes.shape[-1]
    label_dtype = torch.empty((), dtype=labels.dtype).numpy().dtype
    return (packed[..., :d], packed[..., d],
            packed[..., d + 1].astype(label_dtype), packed[..., d + 2] > 0.5)


def _upload(batch: Dict, dev) -> Dict:
    """The batch's arrays on ``dev``, but for its camera sources (and
    records), which the decode reads on the host."""
    cam = {k: batch[k] for k in HOST_KEYS if k in batch}
    rest = {k: v for k, v in batch.items() if k not in cam}
    return {**batch_to(rest, dev), **cam}


def run_inference_generic(predict_fn, model, dataset, batch_size: int,
                          timer=None) -> Dict:
    """Batched inference -> {'bbox_results': per-sample detections in
    dataset order, 'occ_results': per-sample occupancy argmax grids, or
    None when the model predicts none}.  ``predict_fn(model, batch)`` is
    :func:`train.builder.make_predict_fn_generic`'s.

    With more than one rank, each rank infers its contiguous block of the
    dataset (``EvalLoader``'s ``block``), and :func:`parallel.distributed.
    collect_results` gathers the blocks in rank order, trimmed to the
    dataset, so every rank returns the whole dataset's results."""
    timer = timer or _Untimed()
    results: List = [None] * len(dataset)
    occ_results: List = [None] * len(dataset)
    dev = model_device(model)
    loader = EvalLoader(dataset, batch_size, dp.data_parallel_rank(),
                        dp.data_parallel_size())
    batches = iter(loader)
    while True:
        timer.mark('load')
        item = next(batches, None)
        if item is None:
            break
        batch, valid = item
        timer.mark('upload')
        indices = batch.pop('index')
        batch = _upload(batch, dev)
        timer.mark('decode')
        batch = decode_camera_batch(batch, dev)
        timer.mark('model')
        dets, occ_pred = predict_fn(model, batch)
        timer.mark('end')
        boxes, scores, labels, det_valid = detections_to_host(dets)
        if occ_pred is not None:
            occ_pred = occ_pred.cpu().numpy()
        for i, ok in enumerate(valid):
            if ok:
                results[int(indices[i])] = {
                    'boxes': boxes[i], 'scores': scores[i],
                    'labels': labels[i], 'valid': det_valid[i]}
                if occ_pred is not None:
                    occ_results[int(indices[i])] = occ_pred[i]
        if timer.batch_done(int(np.sum(valid))):
            break
    if dp.data_parallel_size() > 1:
        results, occ_results = _collect_blocks(results, occ_results,
                                               loader.block, len(dataset))
    return {'bbox_results': results,
            'occ_results': occ_results if occ_results[0] is not None
            else None}


def _collect_blocks(results: List, occ_results: List, block, n: int):
    """Every rank's results of its ``block``, gathered in dataset order."""
    occ = occ_results[int(block[0])] is not None
    local = [dict(results[int(i)], **({'occ': occ_results[int(i)]}
                                     if occ else {})) for i in block]
    gathered = distributed.collect_results(local, total_size=n)
    results = [{k: r[k] for k in ('boxes', 'scores', 'labels', 'valid')}
               for r in gathered]
    return results, ([r['occ'] for r in gathered] if occ else [None] * n)


def run_streaming_inference(predict_stream, model, dataset,
                            bev_shape) -> List[Dict]:
    """BEVFormer's test-time recurrence over the dataset in (temporal)
    order: :func:`run_streaming_inference_batched` with one stream."""
    return run_streaming_inference_batched(predict_stream, model, dataset,
                                           bev_shape, 1)


def run_streaming_inference_batched(predict_stream, model, dataset,
                                    bev_shape, batch_size: int,
                                    timer=None) -> List[Dict]:
    """Scene-parallel streaming eval, ``predict_stream(model, imgs,
    can_bus, lidar2img, prev_bev, has_prev) -> (dets, bev)`` once per
    step for all streams: ``batch_size`` independent streams,
    each walking a contiguous block of the dataset (the reference's
    rank-contiguous sampler layout turned into batch slots), one call per
    step for all of them.  A stream past its block's end repeats the last
    sample with a zero can_bus and no history, and its output is
    dropped."""
    timer = timer or _Untimed()
    n = len(dataset)
    batch_size = max(1, min(batch_size, n))
    per_slot = -(-n // batch_size)
    streams = [StreamingEvalState(bev_shape) for _ in range(batch_size)]
    results: List = [None] * n
    model_dev = model_device(model)
    dev = None                       # the device the BEVs come back on
    for step in range(per_slot):
        timer.mark('load')
        idxs, valid, samples, cbs, l2is, hps = [], [], [], [], [], []
        for s in range(batch_size):
            idx = s * per_slot + step
            ok = idx < n
            use = idx if ok else n - 1
            sample = dataset[use]
            if ok:
                cb, hp = streams[s].prepare(
                    sample['can_bus'], dataset.infos[use]['scene_token'])
            else:
                cb, hp = sample['can_bus'] * 0.0, False
            idxs.append(use)
            valid.append(ok)
            samples.append(sample)
            cbs.append(cb)
            l2is.append(sample['lidar2img'])
            hps.append(hp)
        timer.mark('upload')
        device_decode = JPEG_BYTES in samples[0]
        inputs = {'can_bus': np.stack(cbs), 'lidar2img': np.stack(l2is),
                  'has_prev': np.asarray(hps)}
        if not device_decode:
            inputs['imgs'] = np.stack([s['imgs'] for s in samples])
        inputs = batch_to(inputs, model_dev)
        timer.mark('decode')
        if device_decode:
            inputs['imgs'] = decode_camera_batch(collate(samples),
                                                 model_dev)['imgs']
        timer.mark('model')
        prev = torch.stack([torch.as_tensor(st.prev_bev, device=dev)
                            for st in streams])
        dets, bev = predict_stream(model, inputs['imgs'], inputs['can_bus'],
                                   inputs['lidar2img'], prev,
                                   inputs['has_prev'])
        timer.mark('end')
        dev = bev.device
        boxes, scores, labels, det_valid = detections_to_host(dets)
        for s in range(batch_size):
            if valid[s]:
                streams[s].update(bev[s])
                results[idxs[s]] = {
                    'boxes': boxes[s], 'scores': scores[s],
                    'labels': labels[s], 'valid': det_valid[s]}
        if timer.batch_done(sum(valid)):
            break
    return results


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
