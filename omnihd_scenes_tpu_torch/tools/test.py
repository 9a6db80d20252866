"""Evaluation CLI (counterpart of ``omnihd_scenes_tpu/tools/test.py``):
load a config and a checkpoint, run batched inference, write the
NewScenes result JSON and/or run the devkit detection eval.

    python -m omnihd_scenes_tpu_torch.tools.test CONFIG CKPT_DIR_OR_FILE \\
        [--eval] [--format-only] [--out-dir DIR] [--cfg-options k=v ...] \\
        [--device cuda|cpu]

It runs on one CUDA device unless ``--device cpu``.  With ``--eval`` the
metrics are printed as JSON and written to ``<out_dir>/metrics.json``.
``--int8``, ``--host-nms`` and ``--bad-conditions`` are not ported yet
and are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

# Flags of the JAX CLI that wait for their ROADMAP items.
UNPORTED_FLAGS = {
    'int8': 'the int8 PTQ tier of the test CLI (ROADMAP queue 1 item 3)',
    'host_nms': 'the native host NMS (ROADMAP queue 1 item 3)',
    'bad_conditions': 'the rainy/night eval slice (ROADMAP queue 1 item 3)'}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', help='checkpoint file or directory (ckpts/)')
    p.add_argument('--eval', action='store_true',
                   help='run the devkit detection eval')
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--out-dir')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    for flag, what in UNPORTED_FLAGS.items():
        p.add_argument('--' + flag.replace('_', '-'), action='store_true',
                       help=f'not ported yet: {what}')
    args = p.parse_args(argv)
    for flag, what in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            p.error(f'--{flag.replace("_", "-")} is not ported yet: {what}')
    return args


def main(argv=None):
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

    dataset = build_dataset_single(cfg.data.get('test', cfg.data.val),
                                   cfg.get('dataset_type', 'det'))
    model, mtype = build_model_from_cfg(cfg)
    model.to(device)
    # A train state shaped like the training side's, so the checkpoint's
    # optimizer state loads as saved.
    state = create_train_state(model, lambda params: make_optimizer(
        params, make_lr_schedule(1e-3, 100, warmup_iters=10)))
    state = load_checkpoint(args.checkpoint, state)

    predict_fn = make_predict_fn_generic(model, mtype,
                                         anchors_for(model, mtype))
    outputs = run_inference_generic(predict_fn, state.model, dataset,
                                    cfg.data.samples_per_device)

    if args.format_only:
        path = dataset.format_results(outputs['bbox_results'], out_dir)
        print('Results written to', path)
        return None

    if args.eval:
        metrics = evaluate_results(dataset, outputs, cfg.dataroot,
                                   cfg.version, cfg.eval_set, out_dir,
                                   verbose=True)
        os.makedirs(out_dir, exist_ok=True)
        with open(osp.join(out_dir, 'metrics.json'), 'w') as f:
            json.dump(metrics, f, indent=2)
        print(json.dumps(metrics, indent=2))
        return metrics
    return outputs


if __name__ == '__main__':
    main()
