"""Time training steps through ``train/loop.py:run_training`` on the card,
for one checkout of the repo; run it once per checkout to compare two.

    python omnihd_scenes_tpu_torch/tools/time_train_feed.py [--root DIR]
        [--cases pillars,pillars_loader,bevformer,r101,host_feed]
        [--out FILE]

Runs as a file, not a module: the package and ``chip_smoke.py`` (whose
synthetic batches and phases it reuses) are imported from ``--root``
(default: the checkout holding this file), so the same script times an
older checkout's loop on the same inputs.  Cases:

* ``pillars``: ``configs/pointpillars_radar.py`` at full width, b8 f32
  (the CLI's precision), ``STEPS`` steps of host (NumPy) batches of
  40,000 points through ``run_training``, after ``WARMUP`` such steps;
* ``pillars_loader``: the same model fed by the config's ``TrainLoader``
  (inline) on an image-less synthetic dataroot, ``EPOCHS`` epochs after
  one warm-up epoch;
* ``bevformer``: ``configs/bevformer_t_r50.py`` at full width, B=1 queues
  under the bf16 policy (a launch-bound step), ``STEPS`` host batches;
* ``r101``: ``chip_smoke.phase_r101_stream`` (phase 26b: the R101-DCN
  stream's ms a frame, whose DCN layers sample through
  ``ops/ms_deform_attn.py:bilinear_sample``);
* ``host_feed``: ``chip_smoke.phase_host_feed`` (phase 28), skipped where
  the checkout's smoke has no such phase.

Each timed case prints one JSON line: wall ms a step from a synchronised
start to the synchronised end of the last step, and samples/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

STEPS = 12
WARMUP = 2
EPOCHS = 4
CASES = ('pillars', 'pillars_loader', 'bevformer', 'r101', 'host_feed')


def _timed_run(state, step, batches, epochs=1):
    """Wall seconds of ``run_training`` over ``batches`` for ``epochs``
    (the loss read once an epoch, at its first step)."""
    import torch

    from omnihd_scenes_tpu_torch.train.loop import run_training

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_training(state, step, batches, epochs, log_interval=10 ** 9)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _pillar_state(smoke, dev):
    import torch

    from omnihd_scenes_tpu_torch.train.builder import (
        anchors_for, build_model_from_cfg, init_model, make_loss_fn_generic)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    cfg = Config.fromfile(smoke.PILLAR_CONFIGS[0])
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(cfg.optimizer.lr, 1000, warmup_iters=0)))
    step = make_train_step(make_loss_fn_generic(
        model, mtype, anchors_for(model, mtype)))
    return cfg, state, step


def case_pillars(smoke, dev):
    import numpy as np

    cfg, state, step = _pillar_state(smoke, dev)
    rng = np.random.RandomState(7)
    batch = smoke.PILLAR_BATCH
    batches = [smoke.pillar_batch(rng, state.model, batch,
                                  smoke.PILLAR_POINTS['radar'])
               for _ in range(WARMUP + STEPS)]
    _timed_run(state, step, batches[:WARMUP])
    seconds = _timed_run(state, step, batches[WARMUP:])
    return {'config': smoke.PILLAR_CONFIGS[0], 'batch': batch,
            'steps': STEPS, 'ms_per_step': seconds * 1e3 / STEPS,
            'samples_per_s': STEPS * batch / seconds}


def case_pillars_loader(smoke, dev):
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)
    from omnihd_scenes_tpu_torch.train.detection import build_datasets

    cfg, state, step = _pillar_state(smoke, dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'synth')
        generate(root, 'v1.0-mini', SyntheticConfig(
            n_scenes=4, samples_per_scene=12, n_radar_points=1000),
            images=False)
        create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                               max_sweeps=0)
        cfg.merge_from_options([
            f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl'])
        train_ds, _ = build_datasets(cfg)
        batch = cfg.data.samples_per_device
        loader = TrainLoader(train_ds, batch, seed=3)
        _timed_run(state, step, loader)
        seconds = _timed_run(state, step, loader, EPOCHS)
    steps = EPOCHS * len(loader)
    return {'config': smoke.PILLAR_CONFIGS[0], 'batch': batch,
            'train_samples': len(train_ds), 'epochs': EPOCHS,
            'steps': steps, 'ms_per_step': seconds * 1e3 / steps,
            'samples_per_s': steps * batch / seconds}


def case_bevformer(smoke, dev):
    import numpy as np

    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_queue_batch)
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import make_train_step

    cfg = smoke._bevformer_cfg(smoke.BEVFORMER_FULL)
    state = smoke._bevformer_train_state(
        cfg, random_bevformer_state_dict(cfg, 0), dev)
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        state.model, 'bevformer', None)))
    rng = np.random.RandomState(250)
    batches = [random_queue_batch(rng, cfg, 1, n_gt=smoke.QUEUE_GT)
               for _ in range(WARMUP + STEPS)]
    _timed_run(state, step, batches[:WARMUP])
    seconds = _timed_run(state, step, batches[WARMUP:])
    return {'config': smoke.BEVFORMER_FULL, 'batch': 1, 'steps': STEPS,
            'ms_per_step': seconds * 1e3 / STEPS,
            'samples_per_s': STEPS / seconds}


def main(args):
    import chip_smoke as smoke
    import torch

    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    records = []
    for name in args.cases.split(','):
        if name == 'r101':
            smoke.phase_r101_stream(dev, card)
            continue
        if name == 'host_feed':
            if hasattr(smoke, 'phase_host_feed'):
                smoke.phase_host_feed(dev, card)
            continue
        rec = {'root': args.root, 'case': name, 'card': card,
               **globals()[f'case_{name}'](smoke, dev)}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, 'a') as f:
            for rec in records:
                f.write(json.dumps(rec) + '\n')


def _parse():
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--root', default=os.path.dirname(os.path.dirname(here)),
                   help='checkout whose package and chip_smoke.py run')
    p.add_argument('--cases', default=','.join(CASES))
    p.add_argument('--out', default=None,
                   help='append the JSON records to this file')
    return p.parse_args()


if __name__ == '__main__':
    ARGS = _parse()
    ARGS.root = os.path.abspath(ARGS.root)
    if ARGS.out:
        ARGS.out = os.path.abspath(ARGS.out)
    # Replace this file's directory (first on the path when run as a file)
    # by the checkout to time.
    sys.path[0] = ARGS.root
    os.chdir(ARGS.root)
    main(ARGS)
