"""Training CLI (counterpart of ``omnihd_scenes_tpu/tools/train.py``).

Config file + ``--cfg-options`` dotted overrides, work-dir logging with
the config dumped beside it, seeding, resume:

    python -m omnihd_scenes_tpu_torch.tools.train \\
        configs/synthetic/pointpillars_radar_synth.py \\
        --cfg-options dataroot=/path/to/synthetic [--work-dir DIR] \\
        [--resume-from CKPT_DIR] [--seed 0] [--no-validate] [--bf16] \\
        [--device cuda|cpu]

It runs on one CUDA device unless ``--device cpu``.  The steps,
checkpoints (``<work_dir>/ckpts/ckpt_<epoch>.pt``), the JSON log
(``<work_dir>/train.log.json``) and the periodic eval go through
``train/loop.py:run_training``; a BEVFusion-OCC config
(``model_type='bevfusion_mtl'``) adds the occupancy losses to the step
and the occupancy metrics to the periodic eval.  A BEVFormer-T config
(``model_type='bevformer'``, ``dataset_type='temporal'``) trains on the
temporal dataset's frame queues with the Hungarian-matched DETR loss and,
as in the JAX package, skips the periodic eval: ``tools.test --eval``
streams the val split from the checkpoint.  Camera configs read their
JPEGs as ``tools.test`` does: on CUDA the datasets carry the JPEG bytes
and the image augmentations' draws (``image_decode='device'``), and the
prefetch thread decodes each batch on its side stream (host entropy
decode, then the IDCT, ``rectify``, ``photometric`` and
``crop_resize_flip`` kernels), with no OpenCV in the process; with
``--device cpu`` they read through OpenCV.  ``data.workers_per_device`` (or ``workers_per_gpu``)
prepares samples in that many spawn processes (``data/worker_pool.py``).
Pretrained and staged weights apply after the model is built, unless
``--resume-from`` restores a checkpoint, which takes precedence as in the
JAX package: ``pretrained`` / ``load_img_from`` through
``train/torch_import.py``, then ``load_lift_from`` / ``load_pts_from``
(a checkpoint of the port, file or directory) through
``train/ckpt_remap.py``; each logs ``{'mode': key, 'loaded': ...}``.
The last log line (``'mode': 'done'``) carries the hand kernels' launch
counts of the run (``kernels.launch_counts``), periodic eval included,
the number of ranks and the process group's backend.

On W GPUs, one rank a GPU (data parallel, as the reference's
``tools/dist_train.sh``):

    torchrun --nproc_per_node W -m omnihd_scenes_tpu_torch.tools.train \
        CONFIG --cfg-options ...

``WORLD_SIZE`` > 1 joins the process group (``parallel/distributed.py``:
NCCL, or gloo with ``--device cpu``), each rank on ``cuda:LOCAL_RANK``.
A step takes the global batch of ``samples_per_device x W``, each rank
its rows (``TrainLoader``), as the JAX package takes ``samples_per_device
x device_count`` over its mesh; BatchNorm and the depth loss take their
statistics over the global batch and the gradients are averaged before
the clip; ``auto_scale_lr`` scales the lr by W / 8.  Rank 0's weights are
broadcast after the init and the staged weights (a resume loads the same
file on every rank); rank 0 alone writes the work dir (config, log,
checkpoints, eval files); the periodic eval infers each rank's block of
the val set, rank 0 evaluates the collected results and every rank
receives the metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import os.path as osp
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config')
    p.add_argument('--work-dir')
    p.add_argument('--resume-from')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--no-validate', action='store_true')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute policy (reference fp16 train path)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: CUDA unless asked for the CPU;
    a CUDA request on a machine without a GPU is an error."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f'--device {name}: no CUDA device is available '
                         f'(pass --device cpu to run on the CPU)')
    return device


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` for a CUDA run, which must
    exist; the CPU as asked."""
    if device.type != 'cuda':
        return device
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise SystemExit(f'LOCAL_RANK {local_rank} has no GPU: this machine '
                         f'has {count} CUDA device(s)')
    torch.cuda.set_device(local_rank)
    return torch.device('cuda', local_rank)


# The hand kernels a CUDA training run of each kind may load.
_CAMERA_KERNELS = ('jpeg_idct', 'rectify', 'photometric', 'crop_resize_flip')


def _build_kernels_on_rank0(mtype: str) -> None:
    """Rank 0 builds the kernels the run may load (one ``nvcc`` each, all
    at once), then every rank meets at a barrier, so the ranks do not all
    compile the same sources."""
    from omnihd_scenes_tpu_torch.kernels._build import build_libraries
    from omnihd_scenes_tpu_torch.parallel import distributed
    from omnihd_scenes_tpu_torch.parallel.mesh import data_parallel_rank
    from omnihd_scenes_tpu_torch.train.builder import CAMERA_FAMILIES

    names = ()
    if mtype in CAMERA_FAMILIES:
        names = ('lss_sample',) + _CAMERA_KERNELS
    elif mtype == 'bevformer':
        names = _CAMERA_KERNELS
    if data_parallel_rank() == 0:
        build_libraries(names)
    distributed.barrier()


def main(argv=None):
    with contextlib.ExitStack() as stack:
        return _main(argv, stack)


def _main(argv, stack):
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.kernels import launch_counts
    from omnihd_scenes_tpu_torch.parallel import distributed
    from omnihd_scenes_tpu_torch.parallel.mesh import (broadcast_state,
                                                       data_parallel_rank,
                                                       data_parallel_size)
    from omnihd_scenes_tpu_torch.data.sampling import wrap_dataset
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg,
                                                       check_family,
                                                       init_model,
                                                       make_loss_fn_generic,
                                                       make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_datasets
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        evaluate_results, run_inference_generic)
    from omnihd_scenes_tpu_torch.train.loop import (JsonLogger,
                                                    create_train_state,
                                                    load_checkpoint,
                                                    make_train_step,
                                                    run_training)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    args = parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get('WORLD_SIZE', '1')) > 1:
        device = rank_device(device, int(os.environ.get('LOCAL_RANK', '0')))
        distributed.init_distributed(device.type)
        stack.callback(distributed.destroy_distributed)
    world, rank = data_parallel_size(), data_parallel_rank()
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    check_family(cfg.get('model_type', 'pointpillars'))
    if args.work_dir:
        cfg.work_dir = args.work_dir
    if rank == 0:
        os.makedirs(cfg.work_dir, exist_ok=True)
        cfg.dump(osp.join(cfg.work_dir, 'config.py'))

    logger = JsonLogger(cfg.work_dir)        # writes on rank 0 only
    logger.log({'mode': 'env', 'device': str(device),
                'device_name': (torch.cuda.get_device_name(device)
                                if device.type == 'cuda' else 'cpu'),
                'config': osp.basename(args.config)})

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    train_ds, val_ds = build_datasets(
        cfg, image_decode='device' if device.type == 'cuda' else 'host')
    train_ds = wrap_dataset(train_ds, cfg.data.train.get('wrapper'))
    # The global batch, as JAX's samples_per_device x device_count.
    batch_size = cfg.data.samples_per_device * world
    train_loader = TrainLoader(
        train_ds, batch_size, seed=args.seed,
        num_workers=int(cfg.data.get('workers_per_device',
                                     cfg.data.get('workers_per_gpu', 0))),
        group_flags=getattr(train_ds, 'group_flags', None),
        rank=rank, world_size=world)
    stack.callback(train_loader.close)

    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    if world > 1 and device.type == 'cuda':
        _build_kernels_on_rank0(mtype)

    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * cfg.total_epochs
    opt_cfg = cfg.optimizer
    # Linear LR scaling (reference tools/train.py:173-175; JAX
    # tools/train.py:95-96): lr x ranks / 8.
    lr = (opt_cfg.lr * world / 8 if cfg.get('auto_scale_lr', False)
          else opt_cfg.lr)
    schedule = make_lr_schedule(
        lr, total_steps,
        policy=cfg.lr_config.get('policy', 'cosine'),
        warmup_iters=min(cfg.lr_config.get('warmup_iters', 500),
                         max(total_steps // 10, 1)),
        warmup_ratio=cfg.lr_config.get('warmup_ratio', 1.0 / 3),
        step_epochs=cfg.lr_config.get('step', None),
        steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, lambda params: make_optimizer(
        params, schedule, opt_cfg.get('weight_decay', 0.01),
        cfg.get('grad_clip_norm', 35.0)))
    if args.resume_from:
        state = load_checkpoint(args.resume_from, state)
        logger.log({'mode': 'resume', 'step': int(state.step)})
    else:
        apply_staged_weights(cfg, model, logger)
    broadcast_state(model)              # rank 0's weights on every rank

    anchors_np = anchors_for(model, mtype)
    loss_fn = make_loss_fn_generic(
        model, mtype, anchors_np,
        depth_loss_weight=cfg.get('img_depth_loss_weight', 1.0))
    if args.bf16 or cfg.get('bf16', False):
        loss_fn = bf16_policy(loss_fn)
    train_step = make_train_step(loss_fn)

    eval_fn = None
    if not args.no_validate and mtype != 'bevformer':
        predict_fn = make_predict_fn_generic(model, mtype, anchors_np)

        def eval_fn(state):
            # Every rank infers its block; rank 0 evaluates them all.
            outputs = run_inference_generic(
                predict_fn, state.model, val_ds, cfg.data.samples_per_device)
            metrics = None
            if rank == 0:
                metrics = evaluate_results(
                    val_ds, outputs, cfg.dataroot, cfg.version, cfg.eval_set,
                    osp.join(cfg.work_dir, 'eval'))
            return distributed.broadcast_object(metrics)

    t0 = time.time()
    state = run_training(
        state, train_step, train_loader, cfg.total_epochs, logger=logger,
        log_interval=cfg.get('log_interval', 50),
        ckpt_dir=osp.join(cfg.work_dir, 'ckpts'),
        ckpt_interval=cfg.get('ckpt_interval', 1),
        eval_fn=eval_fn, eval_interval=cfg.get('eval_interval', 1))
    logger.log({'mode': 'done', 'wall_time': time.time() - t0,
                'final_step': int(state.step),
                'kernel_launches': launch_counts(), 'world_size': world,
                'backend': distributed.backend()})
    return state


@torch.no_grad()
def apply_staged_weights(cfg, model, logger) -> None:
    """``pretrained`` / ``load_img_from``, then ``load_lift_from`` /
    ``load_pts_from``, into ``model`` (JAX ``tools/train.py:115-154``)."""
    from omnihd_scenes_tpu_torch.train import ckpt_remap
    from omnihd_scenes_tpu_torch.train.loop import checkpoint_file
    from omnihd_scenes_tpu_torch.train.torch_import import (apply_pretrained,
                                                            load_state_dict)

    pretrained = cfg.get('pretrained', cfg.model.get('pretrained'))
    load_img_from = cfg.get('load_img_from')
    if pretrained or load_img_from:
        merged, reports = apply_pretrained(
            model.state_dict(), pretrained=pretrained,
            load_img_from=load_img_from,
            resnet_depth=cfg.model.get('resnet_depth'))
        model.load_state_dict(merged)
        for key, rep in reports.items():
            logger.log({'mode': key, 'loaded': len(rep['loaded']),
                        'missing': len(rep.get('missing', ())),
                        'mismatched': len(rep.get('mismatched', ())),
                        'skipped': len(rep.get('skipped', ()))})
    for key in ('load_lift_from', 'load_pts_from'):
        path = cfg.get(key)
        if path:
            source = load_state_dict(checkpoint_file(path))
            merged, report = getattr(ckpt_remap, key)(
                dict(model.named_parameters()), source)
            for name in report['loaded']:
                model.get_parameter(name).copy_(merged[name])
            logger.log({'mode': key, 'loaded': len(report['loaded'])})


if __name__ == '__main__':
    main()
