"""Fuse Conv+BN in a trained checkpoint for deployment (counterpart of
``omnihd_scenes_tpu/tools/fuse_conv_bn.py``; reference
``tools/misc/fuse_conv_bn.py``).

Loads a config and a checkpoint, traces the model on the test dataset's
first sample (BEVFormer through its streaming forward with a zero
previous BEV, as ``StreamPredictor`` runs it), folds each BN's frozen
statistics into its producer (``serve/fuse.py``: dataflow-exact pairing,
the BN left as a passthrough) and writes the fused checkpoint in the
port's format (``train/loop.py:save_checkpoint``), ready for
``tools/test.py``, ``tools/export.py`` and ``Predictor``:

    python -m omnihd_scenes_tpu_torch.tools.fuse_conv_bn CONFIG CKPT \\
        --out OUT_DIR [--cfg-options k=v ...] [--device cuda|cpu]

It runs on one CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Fuse conv+BN in a checkpoint')
    p.add_argument('config')
    p.add_argument('checkpoint', help='checkpoint file or directory (ckpts/)')
    p.add_argument('--out', required=True, help='output checkpoint directory')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def trace_inputs(model, mtype: str, dataset, device):
    """``run()``: one forward of ``model`` on the dataset's first sample,
    on ``device`` (camera sources decoded there)."""
    import numpy as np
    import torch

    from omnihd_scenes_tpu_torch.data.image_loading import (
        decode_camera_batch)
    from omnihd_scenes_tpu_torch.data.loader import EvalLoader, collate
    from omnihd_scenes_tpu_torch.train.builder import model_inputs
    from omnihd_scenes_tpu_torch.train.loop import batch_to

    if mtype == 'bevformer':
        sample = dataset[0]
        cfg = model.cfg
        imgs = decode_camera_batch(collate([sample]), device)['imgs']
        args = (torch.as_tensor(imgs).to(device),
                torch.from_numpy(np.asarray(sample['can_bus'][None],
                                            np.float32)).to(device),
                torch.from_numpy(np.asarray(sample['lidar2img'][None],
                                            np.float32)).to(device),
                torch.zeros(1, cfg.bev_h * cfg.bev_w, cfg.embed_dims,
                            device=device),
                torch.zeros(1, dtype=torch.bool, device=device))
        return lambda: model.forward_stream(*args)
    batch, _ = next(iter(EvalLoader(dataset, 1)))
    inputs = model_inputs(batch_to(decode_camera_batch(batch, device),
                                   device), mtype)
    return lambda: model(*inputs)


def main(argv=None):
    from omnihd_scenes_tpu_torch.serve.fuse import fuse_model
    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    dataset = build_dataset_single(
        cfg.data.get('test', cfg.data.val), cfg.get('dataset_type', 'det'),
        image_decode='device' if device.type == 'cuda' else 'host')
    model, mtype = build_model_from_cfg(cfg)
    model.to(device)
    state = create_train_state(model, lambda params: make_optimizer(
        params, make_lr_schedule(1e-3, 100, warmup_iters=10)))
    state = load_checkpoint(args.checkpoint, state)

    fused, report = fuse_model(model, trace_inputs(model, mtype, dataset,
                                                   device))
    print(f"fuse_conv_bn: {len(report['fused'])} BN folded, "
          f"{len(report['skipped'])} skipped")
    for s in report['skipped'][:10]:
        print('  skipped:', s)
    model.load_state_dict(fused)
    path = save_checkpoint(args.out, state, state.step or 1)
    print('fused checkpoint written to', path)
    return report


if __name__ == '__main__':
    main()
