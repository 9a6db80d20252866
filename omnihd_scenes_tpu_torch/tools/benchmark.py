"""Inference FPS over a dataroot (counterpart of
``omnihd_scenes_tpu/tools/benchmark.py``; reference
``tools/analysis_tools/benchmark.py:1-102``).

    python -m omnihd_scenes_tpu_torch.tools.benchmark CONFIG \\
        [--checkpoint CKPT] [--samples 100] [--warmup 5] \\
        [--cfg-options k=v ...] [--device cuda|cpu]

Samples/s of the model over the val set at ``data.samples_per_device``,
through the eval runner ``tools.test`` runs (``train/eval_runner.py``:
``run_inference_generic``, or for BEVFormer the scene-parallel streams
of ``run_streaming_inference_batched``), after ``--warmup`` batches, with
one device synchronisation a batch (the detections' copy to the host, as
JAX's scalar readback, ``:65``).  The val set is walked again from its
start until ``--samples`` samples are timed (the JAX tool stops at its
end).  Beside the FPS line it prints the ms per sample of each stage:
loading (the host's ``EvalLoader`` step, or the streams' dataset reads;
host clock), upload (the batch's arrays to the device), decode + rectify
(the host entropy decode, ``kernels/jpeg_idct.py`` and
``kernels/rectify.py``; 0 on the host path) and model +
decode (forward, box decode and NMS), the last three by CUDA events on
the card and by the host clock with ``--device cpu`` (where the images
take the OpenCV host path); and one JSON line of the same numbers.
Without ``--checkpoint`` the weights are seeded (``init_model``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

STAGES = ('load', 'upload', 'decode', 'model')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Benchmark inference FPS')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--samples', type=int, default=100)
    p.add_argument('--warmup', type=int, default=5,
                   help='untimed batches first')
    p.add_argument('--cfg-options', nargs='+')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


class StageTimer:
    """The eval runners' ``timer``: the stage marks of each batch (CUDA
    events on the card beside the host clock), the first ``warmup``
    batches untimed, and the run ended once ``samples`` samples are
    timed."""

    def __init__(self, device, warmup: int, samples: int):
        self.cuda = device.type == 'cuda'
        self.warmup, self.samples = warmup, samples
        self.totals = dict.fromkeys(STAGES, 0.0)
        self.seen = self.n_batches = self.n_done = 0
        self.t_start = None
        self.marks = {}

    @property
    def finished(self) -> bool:
        return self.n_done >= self.samples

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        if stage == 'load' and self.seen == self.warmup \
                and self.t_start is None:
            self.t_start = now
        event = None
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.marks[stage] = (now, event)

    def _ms(self, a: str, b: str) -> float:
        (ta, ea), (tb, eb) = self.marks[a], self.marks[b]
        return ea.elapsed_time(eb) if self.cuda else (tb - ta) * 1e3

    def batch_done(self, n_samples: int) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        self.totals['load'] += (self.marks['upload'][0]
                                - self.marks['load'][0]) * 1e3
        for stage, nxt in zip(STAGES[1:], (*STAGES[2:], 'end')):
            self.totals[stage] += self._ms(stage, nxt)
        self.n_done += n_samples
        self.n_batches += 1
        return self.finished


def main(argv=None):
    from omnihd_scenes_tpu_torch.tools.train import resolve_device
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg,
                                                       init_model,
                                                       make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        run_inference_generic, run_streaming_inference_batched)
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    load_checkpoint)
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
    init_model(model, torch.Generator().manual_seed(0))
    model.to(device)
    if args.checkpoint:
        state = create_train_state(model, lambda params: make_optimizer(
            params, make_lr_schedule(1e-3, 100, warmup_iters=10)))
        load_checkpoint(args.checkpoint, state)
    model.eval()
    bs = int(cfg.data.get('samples_per_device', 1) or 1)
    predict = make_predict_fn_generic(model, mtype, anchors_for(model, mtype))
    if mtype == 'bevformer':
        bev_shape = (model.cfg.bev_h * model.cfg.bev_w, model.cfg.embed_dims)

        def walk(timer):
            run_streaming_inference_batched(predict, model, dataset,
                                            bev_shape, bs, timer)
    else:
        def walk(timer):
            run_inference_generic(predict, model, dataset, bs, timer)

    timer = StageTimer(device, args.warmup, args.samples)
    while not timer.finished:
        seen = timer.seen
        walk(timer)
        if timer.seen == seen:
            raise ValueError('tools.benchmark: the val set is empty')
    dt = time.perf_counter() - timer.t_start
    n_done, n_batches, totals = timer.n_done, timer.n_batches, timer.totals
    per = {k: v / max(n_done, 1) for k, v in totals.items()}
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'Overall fps: {n_done / dt:.2f} samples/sec '
          f'({dt / max(n_done, 1) * 1000:.1f} ms/sample) on {name}')
    print('ms/sample: ' + ', '.join(f'{k} {per[k]:.3f}' for k in STAGES)
          + f' ({n_done} samples, {n_batches} batches of {bs})')
    result = {'fps': n_done / dt, 'ms_per_sample': per, 'samples': n_done,
              'batch': bs, 'device': name,
              'decode': dataset.image_decode if dataset.use_camera
              else None}
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
