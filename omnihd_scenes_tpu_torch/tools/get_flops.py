"""FLOPs / parameter counter (counterpart of
``omnihd_scenes_tpu/tools/get_flops.py``; reference
``tools/analysis_tools/get_flops.py``, mmcv's flops_counter over one
forward).

Parameters are the ``numel`` sum of the built model's parameters (the
JAX package's walk over the ``params`` collection).  FLOPs are counted
by ``torch.utils.flop_counter.FlopCounterMode`` over one eval-mode
forward of ``build_model_from_cfg``'s model on ``example_batch_for``'s
batch: the convolutions, matmuls and attention products, plus the LSS
view transform, an opaque registered op (``omnihd::lss_sample_bev``)
counted by :func:`lss_sample_bev_flops` from its shapes, so the count is
the same on the card and on the CPU.  Elementwise work is not counted;
XLA's ``cost_analysis`` in the JAX package counts it after fusion, so the
two figures differ, and the JAX tool's "hbm bytes/fwd" has no
counterpart here.

Usage:
    python -m omnihd_scenes_tpu_torch.tools.get_flops CONFIG \\
        [--cfg-options k=v ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math

import torch


def lss_sample_bev_flops(feat_shape, depth_shape, minv_shape, mt_shape,
                         geom, solve_x, out_shape=None, **kwargs) -> int:
    """FLOPs of the LSS kernel from its shapes: every output value (B,
    ny, nx, nz, C) sums one feature x depth product per camera, two
    operations each (an upper bound: a camera that does not see a cell
    adds nothing)."""
    return 2 * math.prod(out_shape) * feat_shape[1]


def count(cfg, device='cuda') -> dict:
    """{'model_type', 'params', 'flops'} of ``cfg``'s model with seeded
    weights, one forward at batch 1 on ``device``."""
    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)

    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    return count_model(model, mtype, device)


def count_model(model, mtype: str, device='cuda') -> dict:
    """:func:`count` of a built model, which it moves to ``device`` in
    eval mode with no parameter needing a gradient."""
    from torch.utils.flop_counter import FlopCounterMode

    import omnihd_scenes_tpu_torch.kernels.lss_sample  # noqa: F401 (the op)
    from omnihd_scenes_tpu_torch.train.builder import example_batch_for

    # No parameter asks for a gradient: FlopCounterMode's module tracker
    # would hook every input that does (BEVFormer passes views of its
    # embeddings to modules) and fails on those with no gradient function.
    model.to(device).eval().requires_grad_(False)
    batch = example_batch_for(model, mtype, device)
    n_params = sum(p.numel() for p in model.parameters())
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.omnihd.lss_sample_bev: lss_sample_bev_flops})
    with torch.no_grad(), counter:
        model(*batch)
    return {'model_type': mtype, 'params': n_params,
            'flops': counter.get_total_flops()}


def main(argv=None):
    p = argparse.ArgumentParser(description='Count FLOPs and params')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help='cuda (default) or cpu')
    args = p.parse_args(argv)

    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(args.cfg_options)
    info = count(cfg, resolve_device(args.device))
    print(f"model: {info['model_type']}")
    print(f"params: {info['params'] / 1e6:.2f} M")
    print(f"forward flops (convs, matmuls, LSS): "
          f"{info['flops'] / 1e9:.2f} GFLOPs")
    print('hbm bytes/fwd: n/a')
    return info


if __name__ == '__main__':
    main()
