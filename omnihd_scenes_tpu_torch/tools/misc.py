"""Misc CLI utilities (counterpart of ``omnihd_scenes_tpu/tools/misc.py``).

Parity targets: ``tools/misc/print_config.py``,
``tools/misc/browse_dataset.py``, ``tools/analysis_tools/get_flops.py``
(``get_params``: parameters per top-level submodule, then the forward
FLOPs of ``tools/get_flops.py``).  Conv + BN fusion is
``tools/fuse_conv_bn.py``.

Usage:
    python -m omnihd_scenes_tpu_torch.tools.misc {print_config,
        browse_dataset,get_params} CONFIG [--cfg-options k=v ...]
        [--out-dir DIR --num N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def _config(args):
    from omnihd_scenes_tpu_torch.train.config import Config

    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    return cfg


def print_config(args):
    import pprint

    pprint.pprint(_config(args).to_dict())


def browse_dataset(args):
    """BEV previews (points and GT boxes, ``tools/visualize.py:draw_bev``)
    of the training split's first ``--num`` samples."""
    from omnihd_scenes_tpu_torch.tools.visualize import draw_bev
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single

    cfg = _config(args)
    ds = build_dataset_single(cfg.data.train, cfg.get('dataset_type', 'det'))
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(args.num, len(ds))):
        s = ds[i]
        if 'points' in s:
            pts = s['points'][s['points_mask']]
            gts = s['gt_boxes'][s['gt_mask']] if 'gt_boxes' in s else None
            draw_bev(pts, gts, out=f'{args.out_dir}/sample_{i}.png')
    print(f'wrote {min(args.num, len(ds))} BEV previews to {args.out_dir}')


def get_params(args):
    """Parameter count per top-level submodule, the total, and the forward
    FLOPs of one batch-1 forward on ``example_batch_for``'s batch."""
    import torch

    from omnihd_scenes_tpu_torch.tools.get_flops import count_model
    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)

    cfg = _config(args)
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    total = 0
    print('Per-submodule parameter counts:')
    for name, sub in model.named_children():
        n = sum(p.numel() for p in sub.parameters())
        total += n
        print(f'  {name:40s} {n / 1e6:8.3f} M')
    print(f'Total params: {total / 1e6:.3f} M')
    info = count_model(model, mtype, resolve_device(args.device))
    print(f"Forward FLOPs (convs, matmuls, LSS): {info['flops'] / 1e9:.2f} G")


def main(argv=None):
    p = argparse.ArgumentParser(description='Misc tools')
    sub = p.add_subparsers(dest='task', required=True)
    for name in ('print_config', 'browse_dataset', 'get_params'):
        sp = sub.add_parser(name)
        sp.add_argument('config')
        sp.add_argument('--cfg-options', nargs='+')
        if name == 'browse_dataset':
            sp.add_argument('--out-dir', default='browse_out')
            sp.add_argument('--num', type=int, default=5)
        if name == 'get_params':
            sp.add_argument('--device', default='cuda',
                            help='cuda (default) or cpu')
    args = p.parse_args(argv)
    {'print_config': print_config,
     'browse_dataset': browse_dataset,
     'get_params': get_params}[args.task](args)


if __name__ == '__main__':
    main()
