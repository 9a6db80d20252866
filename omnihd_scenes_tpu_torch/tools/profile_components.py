"""Per-stage latency profile of the serving path, or of a training step,
on one GPU.

    python -m omnihd_scenes_tpu_torch.tools.profile_components \
        [--batch 4] [--requests 3] [--int8 [--clocks] | --train \
        [--config CONFIG]] [--out profiles/profile_components.txt]

Builds ``Predictor`` at the serving configuration (bf16, channels_last,
seeded random weights; with ``--int8`` in the int8 PTQ tier, calibrated
on one more request) and serves one warm-up and ``--requests`` timed
requests of fresh inputs through :func:`staged_call`, which runs the ops
of ``Predictor.__call__`` in the same order with a CUDA event between
stages (a CPU test holds it equal to ``Predictor``).  Then one more
request runs under ``torch.profiler``: its wall time, device kernel
time, busy share (kernel time / wall), peak allocated memory and the
device kernels that took the most time.  With ``--int8`` a last request
gives the ``qconv`` table: for each eligible layer its shape, the
kernel's tiling, its ms from CUDA events around the launch, its bound
(``tools/roofline.py``: operations over the 1,979 TOP/s int8 peak, or
bytes over 3.35 TB/s if larger), the share of the bound and the gap (ms
- bound).  ``--clocks`` then runs the table's slowest launch back to
back for about 1.5 s and reports the SM clock and board power that
``nvidia-smi`` samples every 100 ms meanwhile (medians; the first two
samples, the ramp, dropped): whether the card's power limit holds the
clock below its maximum under the kernel.

With ``--train`` it profiles the training step instead: the shipped
model (``BEVFusionConfig()``: sorted pillars), or the model that
``--config`` builds (e.g. ``configs/bevfusion_occ.py``, whose loss stage
then holds the occupancy losses; ``configs/bevformer_t_r50.py`` with
``--batch 1``, frame queues of ``random_queue_batch``, whose forward
stage holds the history replay and whose loss stage the matcher's host
round trip), with seeded random f32 weights under
the bf16 policy, one warm-up and ``--requests`` timed steps
of fresh synthetic batches (on the card before the timing) through
``make_train_step(bf16_policy(make_loss_fn_generic(...)))`` itself, given
a ``mark`` that records a CUDA event after the forward, the loss (with
the target assignment), the backward and the optimizer; then one more
step, without marks, under ``torch.profiler``.

The report is printed and written to ``--out``; a relative path is taken
from the root of the checkout.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig, serving_config
from omnihd_scenes_tpu_torch.kernels._conv3x3 import block_n, tile_shape
from omnihd_scenes_tpu_torch.models import quant
from omnihd_scenes_tpu_torch.models.anchor_head import (
    anchor_head_decode_candidates)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.lss import _nhwc
from omnihd_scenes_tpu_torch.ops.nms import multiclass_nms_rotated
from omnihd_scenes_tpu_torch.serve.inputs import CAMERA_INPUTS, upload
from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
from omnihd_scenes_tpu_torch.serve.synthetic import (
    random_bevformer_state_dict, random_queue_batch, random_request,
    random_state_dict, random_train_batch)
from omnihd_scenes_tpu_torch.tools.roofline import bound, conv_cost
from omnihd_scenes_tpu_torch.train.amp import bf16_policy
from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                   make_loss_fn_generic)
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.train.loop import (batch_to, create_train_state,
                                                make_train_step)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)

CHECKOUT = Path(__file__).resolve().parents[2]
N_TOP_KERNELS = 25


@torch.inference_mode()
def staged_call(predictor: Predictor, request, mark):
    """``predictor(*request)`` with ``mark(stage_name)`` called after each
    stage; the serving configuration only (DepthNet, concat fusion)."""
    m, dev = predictor.model, predictor.device
    if not m.lss.use_depthnet:
        raise NotImplementedError('staged_call follows the DepthNet path')
    points, points_mask, imgs, rots, trans = upload(
        CAMERA_INPUTS, request, dev, predictor.dtype)
    mark('inputs to the device')

    pts_bev = m.pillar_canvas(points, points_mask)
    mark('radar: dense pillars')
    pts_bev = m.second_fpn(m.second(pts_bev))
    mark('radar: SECOND + FPN')

    b, n = imgs.shape[:2]
    flat = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)
    feat = m.resnet(flat.to(m.fuse.conv.weight.dtype))
    mark('camera: ResNet50')
    feat = m.fpnc(feat)
    mark('camera: FPNC')
    ctx, depth, _ = m.lss.depthnet(feat)
    mark('camera: DepthNet + ASPP')
    ctx, depth = _nhwc(ctx, b, n), _nhwc(depth, b, n)
    mark('LSS: NHWC copies')
    bev = m.lss.view_transform(depth, ctx, rots, trans)
    mark('LSS: view transform (lss_sample_bev)')
    cam_bev = m.lss.bev_encoder(bev)
    mark('LSS: BEV encoder')

    fused = m.fuse(torch.cat([cam_bev, pts_bev], dim=1))
    if m.se is not None:
        fused = m.se(fused)
    heads = m.head(fused)
    mark('fusion + SE + head')
    dc = predictor.decode_cfg
    boxes, scores = anchor_head_decode_candidates(
        *(t.permute(0, 2, 3, 1).float() for t in heads), predictor.anchors,
        dc)
    mark('decode: top-k + boxes')
    out = multiclass_nms_rotated(boxes, scores, dc.score_thr, dc.nms_thr,
                                 dc.max_num)
    mark('decode: rotated IoU + NMS')
    return out


class StageMarks:
    """``mark(stage)`` records a CUDA event on the current stream;
    :meth:`take` returns {stage: device ms since the mark before it} and
    starts over."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((name, event))

    def take(self):
        torch.cuda.synchronize()
        marks, self.events = self.events, []
        return {name: prev.elapsed_time(event)
                for (_, prev), (name, event) in zip(marks, marks[1:])}


def stage_ms(run, mark: StageMarks):
    """{stage: device ms} of ``run()``, which calls ``mark`` after each
    stage."""
    mark('start')
    run()
    return mark.take()


def kernel_profile(run):
    """Wall ms, device kernel ms and the top kernels of ``run()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if 'CUDA' in str(e.device_type)]
    attr = ('self_device_time_total'
            if hasattr(kernels[0], 'self_device_time_total')
            else 'self_cuda_time_total')
    kernels.sort(key=lambda e: getattr(e, attr), reverse=True)
    return wall, [(getattr(e, attr) / 1e3, e.count, e.key) for e in kernels]


def qconv_layers(predictor, request):
    """[(layer, (N, C, H, W), Co, out bytes per element, device ms)] of one
    request, one row per ``qconv`` launch, timed by CUDA events recorded
    just before and after the launch on the current stream; and a
    callable that repeats the slowest launch."""
    current, rows, calls = [], [], []
    hooks = [m.register_forward_pre_hook(
        lambda module, args, name=name: current.append(name))
        for name, m in predictor.model.named_modules()
        if isinstance(m, quant.QConv2d) and quant.qconv_eligible(m)]
    launch = quant.qconv3x3

    def timed(x8, w8, scale, shift, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(x8, w8, scale, shift, **kwargs)
        end.record()
        rows.append((current[-1], tuple(x8.shape), w8.shape[0],
                     out.element_size(), start, end))
        calls.append((x8, w8, scale, shift, kwargs))
        return out

    quant.qconv3x3 = timed
    try:
        predictor(*request)
        torch.cuda.synchronize()
    finally:
        quant.qconv3x3 = launch
        for hook in hooks:
            hook.remove()
    rows = [(name, shape, co, out_bytes, start.elapsed_time(end))
            for name, shape, co, out_bytes, start, end in rows]
    x8, w8, scale, shift, kwargs = calls[max(range(len(rows)),
                                             key=lambda k: rows[k][-1])]
    return rows, lambda: launch(x8, w8, scale, shift, **kwargs)


def qconv_table(rows):
    """Report lines: per launch its shape, tiling, ms, bound and gap."""
    lines = ['layer | (N, C, H, W) -> Co | tile BHxBW, BN | ms | bound ms '
             '(by) | share | gap ms']
    total_ms = total_bound = 0.0
    for name, (n, c, h, w), co, out_bytes, ms in rows:
        ops, nbytes = conv_cost(n, c, h, w, co, 1, out_bytes)
        bound_ms, bound_by = bound(ops, 'int8', nbytes)
        bh, bw = tile_shape(h, w)
        lines.append(
            f'{name} | ({n}, {c}, {h}, {w}) -> {co} | {bh}x{bw}, '
            f'{block_n(co)} | {ms:.4f} | {bound_ms:.4f} ({bound_by}) | '
            f'{bound_ms / ms:.3f} | {ms - bound_ms:.4f}')
        total_ms += ms
        total_bound += bound_ms
    lines.append(f'sum of {len(rows)} launches | | | {total_ms:.4f} | '
                 f'{total_bound:.4f} | {total_bound / total_ms:.3f} | '
                 f'{total_ms - total_bound:.4f}')
    return lines


def clocks_during(fn, seconds=1.5):
    """(median SM MHz, median board W, samples) that ``nvidia-smi`` reads
    every 100 ms while ``fn`` runs back to back for about ``seconds``; the
    first two samples (the ramp) are dropped."""
    proc = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '100'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines()[2:]:
        try:
            rows.append([float(v) for v in line.split(',')])
        except ValueError:
            continue                 # '[N/A]' or a cut line
    if not rows:
        raise RuntimeError('nvidia-smi gave no clock samples')
    mhz, watts = (float(np.median([r[i] for r in rows])) for i in (0, 1))
    return mhz, watts, len(rows)


def kernel_lines(what, wall, kernels):
    busy = sum(ms for ms, _, _ in kernels)
    return ([f'profiled {what}: wall {wall:.2f} ms, device kernels '
             f'{busy:.2f} ms, busy share {busy / wall:.3f}, peak allocated '
             f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
             'device ms | launches | kernel']
            + [f'{ms:9.3f} | {count:5d} | {key[:100]}'
               for ms, count, key in kernels[:N_TOP_KERNELS]])


def train_report(card, args):
    """Stage table and kernel profile of the b``args.batch`` train step."""
    if args.config:
        model, mtype = build_model_from_cfg(Config.fromfile(args.config))
    else:
        model, mtype = BEVFusion(BEVFusionConfig()), 'bevfusion'
    cfg = model.cfg
    if mtype == 'bevformer':               # queues, the DETR loss
        model.load_state_dict(random_bevformer_state_dict(cfg, args.seed))
        loss_kw, draw = {'anchors_np': None}, random_queue_batch
    else:
        model.load_state_dict(random_state_dict(cfg, args.seed))
        loss_kw = {'anchors_np': cfg.pillars.anchors(),
                   'camera_depth_range': getattr(
                       cfg, 'fusion', cfg).lss.camera_depth_range}
        draw = random_train_batch
    model.to('cuda', memory_format=torch.channels_last)
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(2e-4, 1000, warmup_iters=0)))

    def train_step(mark=None):
        return make_train_step(bf16_policy(make_loss_fn_generic(
            model, mtype, mark=mark, **loss_kw)), mark)

    rng = np.random.RandomState(args.seed)
    batches = [batch_to(draw(rng, cfg, args.batch), 'cuda')
               for _ in range(args.requests + 2)]
    mark = StageMarks()
    marked = train_step(mark)
    runs = [stage_ms(lambda b=b: marked(state, b), mark)
            for b in batches[:args.requests + 1]][1:]
    lines = [card, f'stage | mean ms | per step (b{args.batch} {mtype} train '
             f'step, bf16 policy, {args.requests} steps after a warm-up, '
             f'CUDA events)']
    for name in runs[0]:
        ms = [r[name] for r in runs]
        lines.append(f'{name} | {np.mean(ms):.3f} | '
                     + ', '.join(f'{x:.3f}' for x in ms))
    total = np.mean([sum(r.values()) for r in runs])
    lines.append(f'sum of stages | {total:.3f} ({args.batch * 1e3 / total:.3f}'
                 f' samples/s)')
    torch.cuda.reset_peak_memory_stats()
    step = train_step()
    wall, kernels = kernel_profile(lambda: step(state, batches[-1]))
    return '\n'.join(lines + ['', *kernel_lines('step', wall, kernels)])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--requests', type=int, default=3)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--int8', action='store_true',
                        help='serve the int8 PTQ tier')
    parser.add_argument('--clocks', action='store_true',
                        help='with --int8: SM clock and board power while '
                        'the slowest qconv launch runs back to back')
    parser.add_argument('--train', action='store_true',
                        help='profile the training step instead of serving')
    parser.add_argument('--config',
                        help='with --train: the config whose model to train '
                        '(default: BEVFusionConfig())')
    parser.add_argument('--out', default='profiles/profile_components.txt')
    args = parser.parse_args(argv)
    if args.clocks and not args.int8:
        parser.error('--clocks needs --int8')
    if args.train and args.int8:
        parser.error('--train profiles the bf16 policy; no --int8')
    if args.config and not args.train:
        parser.error('--config needs --train')
    if not torch.cuda.is_available():
        raise SystemExit('profile_components needs a CUDA device')

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # The int8 tier's other convs are f32 convs of int8 codes, exact in
    # TF32: they run with PyTorch's default (TF32 on for cuDNN), as in
    # chip_smoke.py.  The bf16 network has no f32 convs.
    torch.backends.cudnn.allow_tf32 = args.int8
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        report = train_report(card, args)
        print(report)
        out = CHECKOUT / args.out
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report + '\n')
        return
    cfg = serving_config()
    state_dict = random_state_dict(cfg, args.seed)
    rng = np.random.RandomState(args.seed)
    quant = (calibrate(cfg, state_dict, [random_request(rng, cfg, args.batch)],
                       device='cuda') if args.int8 else None)
    predictor = Predictor(cfg, state_dict, device='cuda',
                          dtype=torch.bfloat16, quant_state=quant)
    requests = [random_request(rng, cfg, args.batch)
                for _ in range(args.requests + 3)]

    mark = StageMarks()
    runs = [stage_ms(lambda r=r: staged_call(predictor, r, mark), mark)
            for r in requests[:args.requests + 1]][1:]
    tier = 'int8' if args.int8 else 'bf16'
    lines = [card, f'stage | mean ms | per request (b{args.batch} {tier}, '
             f'{args.requests} requests after a warm-up, CUDA events)']
    for name in runs[0]:
        ms = [r[name] for r in runs]
        lines.append(f'{name} | {np.mean(ms):.3f} | '
                     + ', '.join(f'{x:.3f}' for x in ms))
    lines.append(f'sum of stages | '
                 f'{np.mean([sum(r.values()) for r in runs]):.3f}')

    torch.cuda.reset_peak_memory_stats()
    wall, kernels = kernel_profile(lambda: predictor(*requests[-2]))
    lines += ['', *kernel_lines('request', wall, kernels)]
    if args.int8:
        conv_ms = sum(ms for ms, _, key in kernels if 'conv3x3_kernel' in key)
        lines += ['', f'qconv per eligible layer, one more b{args.batch} '
                  f'request (profiled request above: qconv kernels '
                  f'{conv_ms:.3f} ms of device time; {card})']
        rows, slowest = qconv_layers(predictor, requests[-1])
        lines += qconv_table(rows)
        if args.clocks:
            name, (n, c, h, w), co = max(rows, key=lambda r: r[-1])[:3]
            with torch.inference_mode():
                mhz, watts, samples = clocks_during(slowest)
            lines.append(f'{name} ({n}, {c}, {h}, {w}) -> {co} back to back: '
                         f'SM clock {mhz:.0f} MHz, board power {watts:.1f} '
                         f'W (median of {samples} nvidia-smi samples; '
                         f'{card})')
    report = '\n'.join(lines)
    print(report)
    out = CHECKOUT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report + '\n')


if __name__ == '__main__':
    main()
