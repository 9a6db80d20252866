"""Per-stage latency profile of the serving path, or of a training step,
on one GPU; or each component of the flagship request timed alone.

    python -m omnihd_scenes_tpu_torch.tools.profile_components \
        [--batch 4] [--requests 3] [--int8 [--clocks] | --train \
        [--config CONFIG]] [--out profiles/profile_components.txt]
    python -m omnihd_scenes_tpu_torch.tools.profile_components \
        --probe [NAMES] [--batch 4] [--iters 8] [--device cuda]

Builds ``Predictor`` at the serving configuration (bf16, channels_last,
seeded random weights; with ``--int8`` in the int8 PTQ tier, calibrated
on one more request) and serves one warm-up and ``--requests`` timed
requests of fresh inputs through ``Predictor.__call__`` itself with the
program's spans on (``utils/timing.py``): the stage table gives each
span's calls, device ms and self device ms (its device time less its
child spans') a request, from the spans' CUDA events, and each of the
program's counters a request (``serve.samples``, ``serve.upload_bytes``,
``kernels.builds``).  Then one more
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
``--config`` builds (e.g. ``configs/bevfusion_occ.py``, whose
``train.loss`` span then holds the occupancy losses;
``configs/bevformer_t_r50.py`` with ``--batch 1``, frame queues of
``random_queue_batch``, whose ``train.forward_loss`` holds the history
replay and whose ``train.loss`` the matcher's host round trip), with
seeded random f32 weights under the bf16 policy, one warm-up and
``--requests`` timed steps of fresh synthetic batches (on the card
before the timing) through
``make_train_step(bf16_policy(make_loss_fn_generic(...)))`` itself with
the spans on (``train.step`` over ``train.forward_loss`` (the
network's own spans, then ``train.loss``), ``train.backward``,
``train.optimizer``); then one more step under ``torch.profiler``.

The report is printed and written to ``--out``; a relative path is taken
from the root of the checkout.

With ``--probe`` (the JAX tool's mode; refused with ``--int8`` or
``--train``) each named component (default: all of :data:`PROBES`, in
the JAX tool's order) runs alone at the serving batch, ``--iters``
iterations chained through a scalar carry (``roofline.chained_time``: one
warm-up, the least of three runs, CUDA events), on the JAX tool's seeded
inputs and production shapes with seeded bf16 weights: ResNet50 with
frozen BN on 6B x 544x960, its 7x7/2 stem alone, FPNC, DepthNet + ASPP,
the LSS view transform (the hand kernel), ``BevEncoderConvs``, the dense
pillar encoder with and without ``fold_bn`` on 40,000 radar points a
sample, its three bare index ops, the radar-only BEVFusion and the anchor
decode + rotated NMS.  It prints the card's name and power limit, then a
JSON line a probe: ``{probe, batch, ms_per_sample, ms_per_iter}``, the
hand kernels launched (``launches`` over ``calls`` chained calls) and,
on the card, one more iteration's device kernel ms and wall ms under
``torch.profiler``.  With ``--wait-for LOCKFILE`` it draws every
probe's inputs first and times once no other process holds LOCKFILE
locked (a caller busy on the card).  ``--device cpu`` runs the probes
on the host; the other modes need the card.  Isolated components sum
above the whole request: each reads its own inputs.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from omnihd_scenes_tpu_torch.config import BEVFusionConfig, serving_config
from omnihd_scenes_tpu_torch.kernels._conv3x3 import block_n, tile_shape
from omnihd_scenes_tpu_torch.models import quant
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
from omnihd_scenes_tpu_torch.serve.synthetic import (
    random_bevformer_state_dict, random_queue_batch, random_request,
    random_state_dict, random_train_batch)
from omnihd_scenes_tpu_torch.tools.roofline import (bound, card_line,
                                                    conv_cost, to_bf16)
from omnihd_scenes_tpu_torch.train.amp import bf16_policy
from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                   make_loss_fn_generic)
from omnihd_scenes_tpu_torch.train.config import Config
from omnihd_scenes_tpu_torch.train.loop import (batch_to, create_train_state,
                                                make_train_step)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)
from omnihd_scenes_tpu_torch.utils import timing

CHECKOUT = Path(__file__).resolve().parents[2]
N_TOP_KERNELS = 25


def span_table(run, n: int, what: str):
    """Report lines of ``run(i)`` for i in 0..n with the program's spans
    on, the first call a warm-up: for each span name, in the order the
    spans first opened, its calls, device ms and self device ms (less its
    child spans') a timed call, from the spans' CUDA events; then each of
    the program's counters (``serve.samples``, ``serve.upload_bytes``,
    ``kernels.builds``...) a timed call."""
    run(0)
    torch.cuda.synchronize()
    was = timing.enabled()
    timing.enable(True)
    timing.reset(setup=True)
    try:
        for i in range(1, n + 1):
            run(i)
        recs = timing.records()
        got = timing.collect()
    finally:
        timing.enable(was)
    first = {}
    for r in recs:
        first[r.name] = min(first.get(r.name, r.t0), r.t0)
    lines = [f'span | calls | device ms | self device ms (a {what}, '
             f'{n} after a warm-up, the spans\' CUDA events)']
    spans = got['spans']
    for name in sorted(spans, key=first.get):
        v = spans[name]
        lines.append(f'{name} | {v["calls"] / n:g} | {v["device_ms"] / n:.3f}'
                     f' | {v["self_device_ms"] / n:.3f}')
    lines.append(f'counter | a {what}')
    for name, v in sorted(got['counters'].items()):
        lines.append(f'{name} | {v / n:g}')
    return lines


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


# ---- isolated component probes (--probe) ---------------------------------
# Each component of the flagship request alone, at the serving batch, on
# the inputs the JAX tool draws (``np.random.RandomState(0)``, f32 cast to
# bf16; the weights seeded and cast to bf16), chained as its
# ``fori_loop`` chains them: every output folded into the scalar carry
# (``_live``), which moves the next iteration's inputs.  A builder takes
# the batch, the device and keyword sizes that default to the JAX tool's
# production shapes, and returns ``(fn, args)`` for
# ``roofline.chained_time``.  Isolated components sum above the whole
# request (each pays its own input reads), and the sub-millisecond ones
# carry the chain's per-iteration cost (the carry's reductions, the
# launches).


def _live(*outs):
    """Every floating, integer or boolean leaf of ``outs`` summed in f32,
    times 1e-30: the carry that makes the next iteration wait for all of
    this one."""
    total = None
    for o in outs:
        if o is None:
            continue
        if isinstance(o, dict):
            o = _live(*o.values())
        elif isinstance(o, (tuple, list)):
            o = _live(*o)
        else:
            o = o.sum(dtype=torch.float32) * 1e-30
        if o is not None:
            total = o if total is None else total + o
    return total


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> an (N, C, H, W) view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


def _seeded_bf16(model: torch.nn.Module, device, seed: int = 0):
    """``model`` with seeded random weights (``weights.init_weights``), its
    floating parameters and buffers in bf16, channels_last, eval mode."""
    from omnihd_scenes_tpu_torch.weights import init_weights

    with torch.no_grad():
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=torch.bfloat16,
                    memory_format=torch.channels_last).eval()


# The JAX tool's draws are kept once made (``functools.lru_cache``):
# ``--wait-for`` draws every probe's inputs before it waits for the card,
# and probes that share a draw (resnet and stem; the four radar probes)
# make it once.


@functools.lru_cache(maxsize=None)
def _normal_draw(*shape) -> np.ndarray:
    """``RandomState(0).randn(*shape)`` in f32."""
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def images_input(b, device, hw=(544, 960)):
    """(x,): B x 6 images, (6B, 3, H, W) bf16 channels_last."""
    return (_nchw(to_bf16(_normal_draw(b * 6, *hw, 3), device)),)


def probe_resnet(b, device='cuda', hw=(544, 960), depth=50):
    """ResNet50 with frozen BN on 6B images -> its three stages."""
    from omnihd_scenes_tpu_torch.models.resnet import ResNet

    model = _seeded_bf16(ResNet(depth=depth, out_indices=(1, 2, 3),
                                frozen_bn=True), device)

    def fn(c, x):
        return _live(*model(x + c.to(x.dtype)))
    return fn, images_input(b, device, hw)


def probe_stem(b, device='cuda', hw=(544, 960)):
    """The 7x7/2 stem conv alone (no BN, no pool) on the same images."""
    model = _seeded_bf16(torch.nn.Conv2d(3, 64, 7, stride=2, padding=3,
                                         bias=False), device)

    def fn(c, x):
        return _live(model(x + c.to(x.dtype)))
    return fn, images_input(b, device, hw)


FPNC_STAGES = ((68, 120, 512), (34, 60, 1024), (17, 30, 2048))


@functools.lru_cache(maxsize=None)
def _fpnc_draw(b, stages):
    rng = np.random.RandomState(0)
    return tuple(rng.randn(b * 6, *s).astype(np.float32) for s in stages)


def fpnc_input(b, device, stages=FPNC_STAGES):
    """The three ResNet stages of 6B images, NCHW bf16 channels_last."""
    return tuple(_nchw(to_bf16(x, device)) for x in _fpnc_draw(b, stages))


def probe_fpnc(b, device='cuda', stages=FPNC_STAGES, target_hw=(136, 240)):
    """FPNC (256 channels out) on the stages, resized to ``target_hw``."""
    from omnihd_scenes_tpu_torch.models.fpnc import FPNC

    model = _seeded_bf16(FPNC(tuple(s[-1] for s in stages), 256, 256,
                              target_hw), device)

    def fn(c, *ss):
        return _live(model([s + c.to(s.dtype) for s in ss]))
    return fn, fpnc_input(b, device, stages)


def depthnet_input(b, device, hw=(136, 240), channels=256):
    """(x,): the FPNC features of 6B cameras, (6B, C, H, W) bf16."""
    x = to_bf16(_normal_draw(b, 6, *hw, channels), device)
    return (_nchw(x.reshape(b * 6, *hw, channels)),)


def probe_depthnet(b, device='cuda', hw=(136, 240), channels=256,
                   depth_bins=59, cam_channels=64):
    """DepthNet (mid = in channels, three BasicBlocks, ASPP) -> context,
    depth and logits."""
    from omnihd_scenes_tpu_torch.models.lss import DepthNet

    model = _seeded_bf16(DepthNet(channels, depth_bins, cam_channels),
                         device)

    def fn(c, x):
        return _live(*model(x + c.to(x.dtype)))
    return fn, depthnet_input(b, device, hw, channels)


@functools.lru_cache(maxsize=None)
def _splat_draw(b, cfg):
    rng = np.random.RandomState(0)
    shape = (b, 6, *cfg.feat_hw)
    return (rng.randn(*shape, cfg.depth_bins).astype(np.float32),
            rng.randn(*shape, cfg.camC).astype(np.float32))


def splat_input(b, device, cfg=None):
    """(depth, feat): the softmax of an f32 draw (B, 6, fH, fW, D) and an
    f32 draw (B, 6, fH, fW, C), both in bf16 (the softmax taken in f32 on
    ``device``)."""
    from omnihd_scenes_tpu_torch.config import LSSConfig

    logits, feat = _splat_draw(b, cfg or LSSConfig())
    depth = torch.softmax(torch.from_numpy(logits).to(device), -1)
    return depth.to(torch.bfloat16), to_bf16(feat, device)


def probe_splat(b, device='cuda', cfg=None):
    """The sampling-dual view transform on the ring rig: the hand LSS
    kernel (``ops/lss_project.py:lss_sample_bev`` ->
    ``kernels/lss_sample.py``), launched once for the batch as
    ``Predictor`` launches it, where the JAX tool loops over the samples
    (a Pallas call each); ``ms_per_sample`` is an iteration over B in
    both."""
    from omnihd_scenes_tpu_torch.config import LSSConfig
    from omnihd_scenes_tpu_torch.ops.lss_project import lss_sample_bev
    from omnihd_scenes_tpu_torch.utils.rig import ring_rig_img2lidar

    cfg = cfg or LSSConfig()
    rots, trans = (torch.from_numpy(np.repeat(a[None], b, 0)).to(device)
                   for a in ring_rig_img2lidar(img_hw=cfg.final_dim))
    nx, ny, nz = cfg.bev_nx
    solve_x = (cfg.cam_solve_x + (True,) * 6)[:6]

    def fn(c, d, f):
        return _live(lss_sample_bev(
            d + c.to(d.dtype), f + c.to(f.dtype), rots, trans,
            image_size=cfg.final_dim, depth_range=cfg.camera_depth_range,
            bev_start=cfg.pc_range[:3], bev_voxel=(cfg.grid,) * 3,
            bev_nx=(nx, ny, nz), solve_x=solve_x))
    return fn, splat_input(b, device, cfg)


def bevencode_input(b, device, hw=(160, 240), channels=1024):
    return (_nchw(to_bf16(_normal_draw(b, *hw, channels), device)),)


def probe_bevencode(b, device='cuda', hw=(160, 240), channels=1024,
                    out_channels=256):
    """``BevEncoderConvs`` on the z-collapsed camera grid."""
    from omnihd_scenes_tpu_torch.models.lss import BevEncoderConvs

    model = _seeded_bf16(BevEncoderConvs(channels, out_channels), device)

    def fn(c, x):
        return _live(model(x + c.to(x.dtype)))
    return fn, bevencode_input(b, device, hw, channels)


RADAR_POINTS = 40000


@functools.lru_cache(maxsize=None)
def _radar_inputs(b, points=RADAR_POINTS):
    """The JAX tool's radar sweeps: ``points`` a sample over the range,
    all valid -> (points (B, P, 8) f32, mask (B, P) bool), not to be
    written (kept)."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-55, 55, (b, points, 8)).astype(np.float32)
    pts[..., 1] = rng.uniform(-38, 38, (b, points))
    pts[..., 2] = rng.uniform(-2, 4, (b, points))
    return pts, np.ones((b, points), bool)


def radar_input(b, device, points=RADAR_POINTS):
    """(points bf16, mask bool) on ``device``, as the JAX tool casts them."""
    pts, mask = _radar_inputs(b, points)
    return to_bf16(pts, device), torch.from_numpy(mask).to(device)


def probe_pillar_encode(b, device='cuda', fold_bn=False,
                        points=RADAR_POINTS, pillars=None):
    """The dense pillar encoder (with ``fold_bn``: the frozen BN folded
    into the max) -> the (B, 64, 320, 480) canvas."""
    from omnihd_scenes_tpu_torch.config import PointPillarsConfig
    from omnihd_scenes_tpu_torch.models.pillar_encoders import (
        DensePillarEncoder)

    pc = pillars or PointPillarsConfig()
    model = _seeded_bf16(DensePillarEncoder(
        feat_channels=pc.pfn_channels, voxel_size=pc.voxel_size,
        point_cloud_range=pc.point_cloud_range, grid_hw=pc.bev_hw,
        fold_bn=fold_bn), device)

    def fn(c, pp, mm):
        return _live(model(pp + c.to(pp.dtype), mm))
    return fn, radar_input(b, device, points)


def scatter_floor_input(b, device, points=RADAR_POINTS, pillars=None):
    """(cells, stats, embeddings): each point's flat canvas cell (its
    sample's offset included; every point valid, clipped to the grid) as
    int64, its first four features and a RandomState(1) (B * P, 64) draw,
    both bf16."""
    from omnihd_scenes_tpu_torch.config import PointPillarsConfig

    lin, stats, emb = _scatter_draw(b, points, pillars or PointPillarsConfig())
    return (torch.from_numpy(lin.astype(np.int64)).to(device),
            to_bf16(stats, device), to_bf16(emb, device))


@functools.lru_cache(maxsize=None)
def _scatter_draw(b, points, pc):
    h, w = pc.bev_hw
    x0, y0 = pc.point_cloud_range[0], pc.point_cloud_range[1]
    vx, vy = pc.voxel_size[0], pc.voxel_size[1]
    pts, _ = _radar_inputs(b, points)
    n = pts.shape[1]
    flat = pts.reshape(b * n, -1)
    ix = np.clip(np.floor((flat[:, 0] - x0) / vx).astype(np.int32), 0, w - 1)
    iy = np.clip(np.floor((flat[:, 1] - y0) / vy).astype(np.int32), 0, h - 1)
    bidx = np.repeat(np.arange(b, dtype=np.int32), n)
    lin = bidx * (h * w) + iy * w + ix
    emb = np.random.RandomState(1).randn(b * n, 64)
    return lin, np.ascontiguousarray(flat[:, :4]), emb


def scatter_floor_ops(cells, stats, emb, rows):
    """The dense pillar encoder's three index ops alone: the per-pillar
    statistics' scatter-add, their gather back to the points, and the
    scatter-max onto a -inf canvas of ``rows`` cells, whose untouched
    cells are then zeroed (so the carry stays finite) -> (pillar means
    gathered (P, 3), canvas (rows, 64))."""
    sums = stats.new_zeros((rows, stats.shape[1])).index_add_(0, cells, stats)
    pmean = sums[cells, 1:]
    canvas = emb.new_full((rows, emb.shape[1]), float('-inf'))
    canvas.scatter_reduce_(0, cells[:, None].expand(-1, emb.shape[1]), emb,
                           'amax')
    return pmean, torch.where(torch.isfinite(canvas), canvas, 0.0)


def probe_scatter_floor(b, device='cuda', points=RADAR_POINTS, pillars=None):
    """The bare scatter / gather traffic of the dense pillar encoder
    (:func:`scatter_floor_ops` at the production shapes and index
    distribution, no PFN matmul, BN or activation): ``pillar_encode``
    less this probe is its arithmetic."""
    from omnihd_scenes_tpu_torch.config import PointPillarsConfig

    pc = pillars or PointPillarsConfig()
    rows = b * pc.bev_hw[0] * pc.bev_hw[1]

    def fn(c, cells, st, em):
        return _live(*scatter_floor_ops(cells, st + c.to(st.dtype),
                                        em + c.to(em.dtype), rows))
    return fn, scatter_floor_input(b, device, points, pc)


def probe_radar(b, device='cuda', points=RADAR_POINTS, pillars=None):
    """The radar-only BEVFusion (dense pillars, SECOND, SECONDFPN, the
    anchor head; no camera, LiDAR fusion or SE) -> its three head maps."""
    from omnihd_scenes_tpu_torch.config import (BEVFusionConfig,
                                                PointPillarsConfig)
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion

    pc = pillars or PointPillarsConfig(pillar_impl='dense')
    model = _seeded_bf16(BEVFusion(BEVFusionConfig(
        camera_stream=False, lc_fusion=False, se=False, pillars=pc)), device)

    def fn(c, pp, mm):
        out = model(pp + c.to(pp.dtype), mm, None, None, None)
        return _live(out['cls_score'], out['bbox_pred'], out['dir_pred'])
    return fn, radar_input(b, device, points)


def decode_input(b, device, pillars=None):
    """(cls, box, dir, anchors): f32 head maps at the head's grid (8
    anchors a cell) and the anchor grid (H, W, A, 9), as the JAX tool draws
    them (it tiles the anchors over the batch; one grid serves all)."""
    from omnihd_scenes_tpu_torch.config import PointPillarsConfig

    return tuple(torch.from_numpy(a).to(device)
                 for a in _decode_draw(b, pillars or PointPillarsConfig()))


@functools.lru_cache(maxsize=None)
def _decode_draw(b, pc):
    anchors = np.ascontiguousarray(pc.anchors())
    h, w = pc.head_hw
    na = anchors.shape[-2]
    rng = np.random.RandomState(0)
    cls = rng.randn(b, h, w, na * 4).astype(np.float32)
    box = rng.randn(b, h, w, na * 9).astype(np.float32) * 0.1
    dirp = rng.randn(b, h, w, na * 2).astype(np.float32)
    return cls, box, dirp, anchors


def probe_decode(b, device='cuda', pillars=None):
    """The anchor decode: top-1000 candidates, boxes, rotated NMS to 500
    (``anchor_head_get_bboxes``, batched) at the 160 x 240 head grid."""
    from omnihd_scenes_tpu_torch.config import DecodeCfg
    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)

    cfg = DecodeCfg()

    def fn(c, cls, box, dirp, anchors):
        return _live(*anchor_head_get_bboxes(cls + c, box, dirp, anchors,
                                             cfg))
    return fn, decode_input(b, device, pillars)


PROBES = {
    'resnet': probe_resnet,
    'stem': probe_stem,
    'fpnc': probe_fpnc,
    'depthnet': probe_depthnet,
    'splat': probe_splat,
    'bevencode': probe_bevencode,
    'pillar_encode': probe_pillar_encode,
    'pillar_encode_fold': lambda b, device='cuda', **kw: probe_pillar_encode(
        b, device, fold_bn=True, **kw),
    'scatter_floor': probe_scatter_floor,
    'radar': probe_radar,
    'decode': probe_decode,
}


def run_probe(name, batch, iters, device='cuda', **sizes):
    """One probe's JSON record: ``{probe, batch, ms_per_sample,
    ms_per_iter}`` (``roofline.chained_time``: one warm-up, the least of
    three chained runs), the hand kernels it launched over all those calls
    (``launches``, with ``calls`` = (1 + 3) x ``iters``: the warm-up is a
    whole chain too), and on the card one more iteration under
    ``torch.profiler``: its device kernel ms and wall ms (a probe bound by
    host launches shows there)."""
    from omnihd_scenes_tpu_torch.kernels import launch_counts
    from omnihd_scenes_tpu_torch.tools.roofline import (TIMED_RUNS,
                                                        chained_time)

    fn, args = PROBES[name](batch, device, **sizes)
    before = launch_counts()
    seconds = chained_time(fn, args, iters, device)
    after = launch_counts()
    out = {'probe': name, 'batch': batch,
           'ms_per_sample': round(seconds * 1e3 / batch, 4),
           'ms_per_iter': round(seconds * 1e3, 4),
           'launches': {k: v - before[k] for k, v in after.items()
                        if v != before[k]},
           'calls': (1 + TIMED_RUNS) * iters}
    if torch.device(device).type == 'cuda':
        carry = torch.zeros((), dtype=torch.float32, device=device)
        with torch.inference_mode():
            wall, kernels = kernel_profile(lambda: fn(carry, *args))
        out['profiled_device_ms'] = round(sum(ms for ms, _, _ in kernels), 4)
        out['profiled_wall_ms'] = round(wall, 4)
        del fn, args
        torch.cuda.empty_cache()
    return out


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
    rng = np.random.RandomState(args.seed)
    batches = [batch_to(draw(rng, cfg, args.batch), 'cuda')
               for _ in range(args.requests + 2)]
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        model, mtype, **loss_kw)))
    lines = [card, f'b{args.batch} {mtype} train step, bf16 policy']
    lines += span_table(lambda i: step(state, batches[i]), args.requests,
                        'step')
    torch.cuda.reset_peak_memory_stats()
    wall, kernels = kernel_profile(lambda: step(state, batches[-1]))
    return '\n'.join(lines + ['', *kernel_lines('step', wall, kernels)])


def probe_report(args):
    """``--probe``: the card's name and power limit, then one JSON line a
    probe (:func:`run_probe`) on ``args.device``."""
    from omnihd_scenes_tpu_torch.tools.roofline import wait_for

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('profile_components --probe: no CUDA device '
                         '(--device cpu runs the probes on the host)')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.probe.split(',')
    if args.wait_for:
        for name in names:            # the draws, kept; nothing on a device
            PROBES[name](args.batch, 'meta')
        wait_for(args.wait_for)
    print(card_line(device), flush=True)
    records = []
    for name in names:
        records.append(run_probe(name, args.batch, args.iters, device))
        print(json.dumps(records[-1]), flush=True)
    return records


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
    parser.add_argument('--probe', nargs='?', const=','.join(PROBES),
                        help='time the named components alone, chained '
                        '(comma-separated; all of them without a value)')
    parser.add_argument('--iters', type=int, default=8,
                        help='with --probe: chained iterations a timed run')
    parser.add_argument('--device', default='cuda',
                        help='with --probe: where the probes run')
    parser.add_argument('--wait-for', metavar='LOCKFILE',
                        help='with --probe: draw every input first, then '
                        'wait until LOCKFILE is not locked before timing')
    parser.add_argument('--out', default='profiles/profile_components.txt')
    args = parser.parse_args(argv)
    if args.probe and (args.int8 or args.train):
        parser.error('--probe times components alone; no --int8 or --train')
    if not args.probe and (args.device != 'cuda' or args.wait_for):
        parser.error('--device and --wait-for go with --probe')
    if args.probe:
        unknown = [n for n in args.probe.split(',') if n not in PROBES]
        if unknown:
            parser.error(f'unknown probes {unknown}; known: {list(PROBES)}')
        return probe_report(args)
    if args.clocks and not args.int8:
        parser.error('--clocks needs --int8')
    if args.train and args.int8:
        parser.error('--train profiles the bf16 policy; no --int8')
    if args.config and not args.train:
        parser.error('--config needs --train')
    if not torch.cuda.is_available():
        raise SystemExit('profile_components needs a CUDA device')

    card = card_line('cuda')
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

    tier = 'int8' if args.int8 else 'bf16'
    lines = [card, f'b{args.batch} {tier} request']
    lines += span_table(lambda i: predictor(*requests[i]), args.requests,
                        'request')

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
