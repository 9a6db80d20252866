"""Evaluation CLI (counterpart of ``omnihd_scenes_tpu/tools/test.py``):
load a config and a checkpoint, run batched inference (the streaming
recurrence for BEVFormer), write the NewScenes result JSON and/or run the
devkit eval (detection, and occupancy for BEVFusion-OCC).

    python -m omnihd_scenes_tpu_torch.tools.test CONFIG CKPT_DIR_OR_FILE \\
        [--eval] [--format-only] [--bad-conditions] [--out-dir DIR] \\
        [--cfg-options k=v ...] [--device cuda|cpu] [--int8] [--host-nms]

It runs on one CUDA device unless ``--device cpu``.  On the card the
camera images are decoded and rectified there (the dataset's
``image_decode='device'``: nvJPEG and ``kernels/rectify.py``); with
``--device cpu`` they take the OpenCV host path.  With ``--eval`` the
metrics are printed as JSON and written to ``<out_dir>/metrics.json``;
``--bad-conditions`` restricts both evals to rainy and night scenes.
The last line printed is the kernels' launch counts of the run
(``kernel launches {...}``, ``kernels.launch_counts``).
BEVFormer streams the dataset in order, one stream, or
``data.samples_per_device`` scene-parallel streams; with
``sca_query_cap < 1`` it first checks each distinct scene rig and warns
loudly if the cap drops hit queries.  ``--int8`` evaluates the int8 PTQ
tier: calibration on the first ``min(4, len(dataset))`` samples at batch
1 in dataset order (BEVFormer through the streaming forward on a cold
stream), freeze in one pass, then the quantized graph.  ``--host-nms``
ends the anchor families' device work at the top-``nms_pre`` candidates
and runs the rotated NMS on the host (``ops/nms_host.py``); BEVFormer's
decode is NMS-free and ignores it.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

# Calibration samples of ``--int8`` (JAX ``tools/test.py:128``).
CALIB_SAMPLES = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', help='checkpoint file or directory (ckpts/)')
    p.add_argument('--eval', action='store_true',
                   help='run the devkit detection eval')
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--bad-conditions', action='store_true',
                   help='evaluate only rainy/night scenes')
    p.add_argument('--out-dir')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--int8', action='store_true',
                   help='evaluate the int8 PTQ tier: calibrate on the first '
                        'samples, freeze int8 weights, run the quantized '
                        'graph')
    p.add_argument('--host-nms', action='store_true',
                   help='run the rotated NMS on the host (native C++ core) '
                        'on the top-nms_pre candidates; anchor families')
    return p.parse_args(argv)


def sca_cap_preflight(model_cfg, dataset) -> int:
    """Hit queries the static SCA cap drops, summed over the dataset's
    distinct scene rigs (calibration is static within a scene); prints a
    warning when it is not 0."""
    from omnihd_scenes_tpu_torch.models.bevformer import sca_overflow_for_rig

    checked, total = set(), 0
    for info in dataset.infos:
        scene = info.get('scene_token', '')
        if scene not in checked:
            checked.add(scene)
            total += sca_overflow_for_rig(
                model_cfg, dataset._load_camera(info)['lidar2img'])
    if total > 0:
        print(f'WARNING: sca_query_cap={model_cfg.sca_query_cap} DROPS '
              f'{total} hit queries across {len(checked)} scene rigs -- '
              f'results will NOT match the dense formulation. Raise '
              f'sca_query_cap (1.0 = exact masked-dense) for this rig.')
    return total


def calibrate_int8(model, mtype: str, dataset) -> dict:
    """The int8 tier of ``--int8`` (JAX ``tools/test.py:92-145``): the
    eval-mode forward in ``calib`` mode over the first ``min(4,
    len(dataset))`` samples at batch 1, in dataset order, then ``freeze``
    on the first.  BEVFormer calibrates through the streaming forward on a
    cold stream (zero previous BEV, no history), as the single-frame
    dataset has no queue.  Returns the quant state and leaves ``model``
    in ``int8`` mode."""
    import itertools

    import numpy as np
    import torch

    from omnihd_scenes_tpu_torch.data.image_loading import (
        decode_camera_batch)
    from omnihd_scenes_tpu_torch.data.loader import EvalLoader, collate
    from omnihd_scenes_tpu_torch.models.quant import calibrate_model, set_mode
    from omnihd_scenes_tpu_torch.serve.predictor import predict_stream
    from omnihd_scenes_tpu_torch.train.builder import model_inputs
    from omnihd_scenes_tpu_torch.train.loop import batch_to

    model.eval()
    n = min(CALIB_SAMPLES, len(dataset))
    dev = next(model.parameters()).device
    if mtype == 'bevformer':
        cfg = model.cfg
        zero_bev = torch.zeros(1, cfg.bev_h * cfg.bev_w, cfg.embed_dims)

        def run(sample):
            imgs = decode_camera_batch(collate([sample]), dev)['imgs']
            predict_stream(model, imgs, sample['can_bus'][None],
                           sample['lidar2img'][None], zero_bev,
                           np.zeros(1, bool))

        batches = [dataset[i] for i in range(n)]
    else:
        def run(batch):
            with torch.no_grad():
                model(*model_inputs(batch_to(decode_camera_batch(batch, dev),
                                             dev), mtype))

        batches = [b for b, _ in itertools.islice(EvalLoader(dataset, 1), n)]
    state = calibrate_model(model, run, batches, freeze_index=0)
    set_mode(model, 'int8')
    print(f'int8 tier: calibrated {len(state)} quant variables')
    return state


def run_bevformer(args, cfg, model, dataset):
    """The streaming eval's outputs (``data.samples_per_device``
    scene-parallel streams, one by default)."""
    from omnihd_scenes_tpu_torch.train.builder import make_predict_fn_generic
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        run_streaming_inference_batched)

    if args.host_nms:
        print('--host-nms ignored: bevformer decode is NMS-free')
    if model.cfg.sca_query_cap < 1.0:
        sca_cap_preflight(model.cfg, dataset)
    bev_shape = (model.cfg.bev_h * model.cfg.bev_w, model.cfg.embed_dims)
    predict = make_predict_fn_generic(model, 'bevformer')
    results = run_streaming_inference_batched(
        predict, model, dataset, bev_shape,
        int(cfg.data.get('samples_per_device', 1) or 1))
    return {'bbox_results': results, 'occ_results': None}


def main(argv=None):
    from omnihd_scenes_tpu_torch.kernels import launch_counts
    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg,
                                                       make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        evaluate_results, run_inference_generic)
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    load_checkpoint)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    out_dir = args.out_dir or osp.join(cfg.work_dir, 'test')

    dataset = build_dataset_single(
        cfg.data.get('test', cfg.data.val), cfg.get('dataset_type', 'det'),
        image_decode='device' if device.type == 'cuda' else 'host')
    model, mtype = build_model_from_cfg(cfg)
    model.to(device)
    # A train state shaped like the training side's, so the checkpoint's
    # optimizer state loads as saved.
    state = create_train_state(model, lambda params: make_optimizer(
        params, make_lr_schedule(1e-3, 100, warmup_iters=10)))
    state = load_checkpoint(args.checkpoint, state)
    if args.int8:
        calibrate_int8(state.model, mtype, dataset)

    if mtype == 'bevformer':
        outputs = run_bevformer(args, cfg, state.model, dataset)
    else:
        predict_fn = make_predict_fn_generic(model, mtype,
                                             anchors_for(model, mtype),
                                             host_nms=args.host_nms)
        outputs = run_inference_generic(predict_fn, state.model, dataset,
                                        cfg.data.samples_per_device)

    launches = launch_counts()
    result = outputs
    if args.format_only:
        path = dataset.format_results(outputs['bbox_results'], out_dir)
        print('Results written to', path)
        result = None
    elif args.eval:
        metrics = evaluate_results(dataset, outputs, cfg.dataroot,
                                   cfg.version, cfg.eval_set, out_dir,
                                   bad_conditions=args.bad_conditions,
                                   verbose=True)
        os.makedirs(out_dir, exist_ok=True)
        with open(osp.join(out_dir, 'metrics.json'), 'w') as f:
            json.dump(metrics, f, indent=2)
        print(json.dumps(metrics, indent=2))
        result = metrics
    print('kernel launches ' + json.dumps(launches))
    return result


if __name__ == '__main__':
    main()
