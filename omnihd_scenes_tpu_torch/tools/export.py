"""Export a trained model as a deployable bundle (counterpart of
``omnihd_scenes_tpu/tools/export.py``, the TensorRT-engine analogue).

    python -m omnihd_scenes_tpu_torch.tools.export CONFIG CKPT --out DIR \\
        [--no-bf16] [--cfg-options k=v ...] [--device cuda|cpu]

Builds the model from the config, loads the checkpoint (a fused one from
``tools/fuse_conv_bn.py`` too) and writes the bundle of
``serve/export.py:export_model`` for synthetic b1 inputs at the config's
shapes (JAX ``train/builder.py:example_batch_for``: 20000 radar points,
the images at ``final_dim``, a scaled-identity rig; for BEVFormer-T a
queue of ``queue_length`` frames at ``img_hw``, zero CAN bus, identity
``lidar2img``, no previous frame).  The bundle loads with
``omnihd_scenes_tpu_torch.serve.export.load_exported(DIR, device)``
without model code.  It is traced on one CUDA device unless ``--device
cpu``; JAX's ``--platforms`` has no counterpart.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Export a deployable bundle')
    p.add_argument('config')
    p.add_argument('checkpoint', help='checkpoint file or directory (ckpts/)')
    p.add_argument('--out', required=True)
    p.add_argument('--no-bf16', action='store_true')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def example_inputs(model, mtype: str):
    """JAX ``example_batch_for``: seeded b1 inputs at the config's shapes
    (the camera families' rig a scaled identity, as JAX's; BEVFormer's
    queue with a leading batch of 1)."""
    import numpy as np

    from omnihd_scenes_tpu_torch.train.builder import PILLAR_FAMILIES

    rng = np.random.RandomState(0)
    if mtype == 'bevformer':
        cfg = model.cfg
        q, nv, (h, w) = cfg.queue_length, cfg.num_cams, cfg.img_hw
        imgs = rng.randn(1, q, nv, h, w, 3).astype(np.float32)
        l2i = np.tile(np.eye(4, dtype=np.float32), (1, q, nv, 1, 1))
        return (imgs, np.zeros((1, q, 18), np.float32), l2i,
                np.zeros((1, q), bool))
    n = 20000
    pts = rng.uniform(-50, 50, (1, n, getattr(model, 'point_dims', 8)))
    pts = pts.astype(np.float32)
    mask = np.ones((1, n), bool)
    if mtype in PILLAR_FAMILIES:
        return pts, mask
    fcfg = model.cfg.fusion if mtype == 'bevfusion_mtl' else model.cfg
    h, w = fcfg.lss.final_dim
    nv = fcfg.num_views
    imgs = rng.randn(1, nv, h, w, 3).astype(np.float32)
    rots = np.tile(np.eye(3, dtype=np.float32) * 0.01, (1, nv, 1, 1))
    trans = np.zeros((1, nv, 3), np.float32)
    if not fcfg.radar_stream:
        pts = mask = None
    if not fcfg.camera_stream:
        imgs = rots = trans = None
    return pts, mask, imgs, rots, trans


def main(argv=None):
    from omnihd_scenes_tpu_torch.serve.export import export_model
    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.loop import checkpoint_file

    import torch

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    model, mtype = build_model_from_cfg(cfg)
    payload = torch.load(checkpoint_file(args.checkpoint),
                         map_location='cpu', weights_only=True)
    out = export_model(model, mtype, payload['model'],
                       example_inputs(model, mtype), args.out,
                       anchors=anchors_for(model, mtype),
                       bf16=not args.no_bf16, device=device)
    print(f'exported bundle -> {out}')
    return out


if __name__ == '__main__':
    main()
