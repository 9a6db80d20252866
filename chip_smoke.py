#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA device, ``nvcc`` and
``nvidia-smi``, and imports no JAX.  Phases, one line each (or more):

1. device: torch/CUDA versions, the card's name and power limit; TF32
   off for the parity phases;
2. build: the three kernels (``kernels/csrc/lss_sample.cu``,
   ``qconv.cu``, ``bconv.cu``) from source for sm_90a, one ``nvcc`` each,
   all started together; build seconds, registers and spills;
3. the LSS kernel vs plain at production shapes (6 cameras, 136x240
   features, 59 depth bins, 64 channels, 16x160x240 grid) at batch 1 and
   4, with the bench's ring rig and with the rig moved per sample and
   camera (``utils/rig.py:perturbed_rigs``): the fused kernel
   (``lss_sample_bev``, geometry in) dumps the (j, i, kd) it used for
   every cell and camera, which must equal the plain fields computed on
   the card (or differ in at most 1e-3 of the entries, each by +-1 or at
   a validity edge, and the output is then held to the plain gather on
   the kernel's own indices); f32 output within 1e-5 * max|ref| + 1e-6
   of the plain PyTorch version on the same bf16 inputs, identical
   support, bf16 output within 1 bf16 ulp of the rounded f32 output; the
   fields-in entry (``lss_sample``) held the same way at b4; times at b4:
   the fused kernel, the serving stage (``camera_geometry`` + the fused
   kernel), the two-step path (``sample_fields`` + the fields-in entry), the
   fields-in entry alone and both plain versions, with the bounds of
   ``lss_sample_bev_bytes`` / ``lss_sample_bytes``;
4. small-size parity: the f32 Predictor on the GPU against the f32
   Predictor on the CPU (which the CPU tests hold to the JAX package):
   network outputs within 1e-4 of max|ref|, and decode + NMS on the same
   head maps keeping the same boxes;
5. serving: the full-width serving configuration (R50 + FPNC + DepthNet
   + LSS 16x160x240 + dense pillars 320x480 + SECOND/FPN + head) in bf16
   channels_last with seeded random weights answers one warm-up and 3
   timed batch-4 requests of fresh inputs; outputs must be finite and
   (4, 500, .), ``lss_sample_bev`` must launch once per request and the
   fields-in entry never;
6. bf16 vs f32: the last timed request again, through the bf16 network
   and through an f32 Predictor on the same weights: head maps and the
   fused BEV within HEAD_TOL of max|f32|, and at least BOX_MATCH of the
   kept bf16 boxes overlapping a kept f32 box of the same label;
7. qconv vs plain at the int8 tier's b4 serving shapes (DepthNet block,
   FPNC reduce, BEV encoder) and at edge shapes of the kernel's tiling
   (images smaller than a tile, widths that split tiles, the fuse.conv
   shape C=640 -> Co=384, a Co that is not a multiple of the block's
   channel tile) on seeded int8 codes over +-127: f32 output within
   2^-22 |ref| of the plain version (exact integer sums on both sides),
   bf16 output within 1 ulp on under 1e-3 of the entries; for every
   shape the kernel's ms, TOP/s and share of its bound, and the library
   yardsticks (``torch._int_mm`` on a pre-built s8 im2col matrix of the
   same (M, 9C, Co), its building not timed, and cuDNN's bf16 conv of
   the same shape); the plain version's time at the b4 shapes;
8. bconv vs plain at (24, 256, 136, 240) -> 256, dilation 1/6/12/18,
   ReLU on and off, and at edge shapes (as phase 7, plus d=18 on a 9x13
   image): bf16 output within 1 ulp of the plain f32 result rounded
   (+ 1e-5 max|ref| for cancellation); kernel ms, TFLOP/s, share of its
   bound, plain, cuDNN bf16 conv alone and cuDNN conv + separate BN +
   ReLU times; then its entry point on the ASPP dilated branches of
   phase 6's request (BatchNorm folded into scale/shift) against the
   model's own conv + BN + ReLU;
9. int8 parity at small size: a quant state calibrated on the CPU, the
   f32 int8 Predictor on the GPU (kernel route) against the one on the
   CPU (plain route): every quantized conv on the GPU's input within one
   f32 rounding (eligible) or 1e-5 (others) of the CPU module; network
   outputs within INT8_SMALL_TOL of max|ref|, beside the CPU path's own
   response to a one-ulp change of the images; qconv launched once per
   eligible layer;
10. int8 serving: calibrate (+ freeze) on one fresh full-width b4 request
   in bf16, then 1 warm-up and 3 timed requests of fresh inputs through
   ``Predictor(quant_state=...)``; finite (4, 500, .) outputs, qconv
   launches = eligible layers x requests, ``lss_sample_bev`` once per
   request and the fields-in entry never;
11. int8 vs bf16 on the last timed request: head maps within
   INT8_HEAD_TOL of max|bf16|, at least INT8_BOX_MATCH of the kept int8
   boxes overlapping a kept bf16 box of the same label.

The line before the last is a JSON object of the kernels (launches on
the main paths, error against the plain version, kernel / plain /
library ms, and the bound of ``tools/roofline.py``: the larger of the
call's operations over the card's dense peak for their type and the
bytes it must move, each needed input element read once and each output
written once, over 3.35 TB/s; for the LSS kernel the elements that this
run's indices gather, and for its fields-in entry the fields it reads
too); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero, without that line.
"""

from __future__ import annotations

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BATCH = 4
N_TIMED = 3
# Phase 6 limits; one H100 run with the seeded weights read 1.3e-2 and
# 0.956, so bf16 rounding alone stays well inside them.
HEAD_TOL = 3e-2
BOX_MATCH = 0.9
# Phases 9 and 11 limits, set from the first H100 runs (see PERF.md): the
# random-weight int8 network's outputs move by up to 4.5e-2 of max|ref|
# when an f32 rounding anywhere flips a code (phase 9 prints this floor);
# int8 against bf16 at full width read 5.2e-2 and 0.90 of boxes matched.
INT8_SMALL_TOL = 0.1
INT8_HEAD_TOL = 0.15
INT8_BOX_MATCH = 0.75
CSRC = 'omnihd_scenes_tpu_torch/kernels/csrc/'
KERNELS = ('lss_sample', 'qconv', 'bconv')
SPLAT_PASSES = ('omnihd_scenes_tpu/ops/pallas_splat.py:68',
                'omnihd_scenes_tpu/ops/pallas_splat.py:80')
KERNEL_REPLACES = {
    'lss_sample': SPLAT_PASSES,
    'lss_sample_fields_in': SPLAT_PASSES,
    'qconv': ('omnihd_scenes_tpu/ops/qconv.py:48',),
    'bconv': ('omnihd_scenes_tpu/ops/bconv.py:41',)}
# (N, C, H, W) -> Co of the int8 tier's eligible layers at b4 (24 images).
QCONV_SHAPES = {'DepthNet block': ((24, 256, 136, 240), 256),
                'FPNC reduce': ((24, 768, 136, 240), 256),
                'BEV encoder': ((4, 1024, 160, 240), 1024)}
# Edge shapes of the block tiling (conv3x3.cuh: 128-pixel rectangles of
# 2x64 .. 16x8, 128 or 256 output channels per block).
QCONV_EDGES = {'1x1 image': ((4, 256, 1, 1), 256),
               '7x9 image': ((2, 128, 7, 9), 128),
               'w=30 (ResNet layer4)': ((24, 512, 17, 30), 512),
               'w=131': ((1, 128, 6, 131), 256),
               'fuse.conv C=640 -> Co=384': ((4, 640, 160, 240), 384),
               'Co=136 (not a multiple of BN)': ((2, 128, 9, 13), 136)}
BCONV_SHAPE = ((24, 256, 136, 240), 256)
BCONV_DILATIONS = (1, 6, 12, 18)
BCONV_EDGES = {'1x1 image': ((4, 128, 1, 1), 128, 1),
               '7x9 image': ((2, 256, 7, 9), 256, 6),
               'w=30': ((2, 256, 17, 30), 256, 12),
               'w=131': ((1, 128, 6, 131), 128, 6),
               'd=18 on 9x13': ((2, 128, 9, 13), 256, 18),
               'fuse.conv C=640 -> Co=384': ((4, 640, 160, 240), 384, 1),
               'Co=136 (not a multiple of BN)': ((2, 128, 9, 13), 136, 2)}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters, warmup):
    """Mean device milliseconds per call, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this smoke test needs an NVIDIA GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}; TF32 off')
    print(smi)
    return smi


def phase_build():
    from omnihd_scenes_tpu_torch.kernels import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name in KERNELS:
        path = _build.library_path(name)
        ptxas = [l.strip() for l in
                 (path.parent / 'nvcc.log').read_text().splitlines()
                 if 'registers' in l or 'spill' in l]
        print(f'[2 build] {name}.cu -> {path.name} in {seconds[name]:.2f} s '
              f'(all three in parallel); ' + ' | '.join(ptxas))


def _production_geometry(batch, dev, moved):
    """The serving LSS geometry at ``batch``: the bench's ring rig, the
    same for every sample or (``moved``) moved per sample and camera."""
    import torch

    from omnihd_scenes_tpu_torch.config import serving_config
    from omnihd_scenes_tpu_torch.ops.lss_project import _Geom, camera_geometry
    from omnihd_scenes_tpu_torch.utils.rig import (perturbed_rigs,
                                                   ring_rig_img2lidar)

    lss = serving_config().lss
    nx, ny, nz = lss.bev_nx
    g = _Geom(lss.final_dim, lss.feat_hw, lss.camera_depth_range,
              lss.pc_range[:3], (lss.grid,) * 3, (nx, ny, nz))
    rots, trans = ring_rig_img2lidar(img_hw=lss.final_dim)
    if moved:
        rots, trans = perturbed_rigs(rots, trans, batch, seed=batch)
    else:
        rots, trans = (a[None].repeat(batch, 0) for a in (rots, trans))
    rots, trans = (torch.from_numpy(a).to(dev) for a in (rots, trans))
    minv, mt = camera_geometry(rots, trans)
    return lss, g, rots, trans, minv.contiguous(), mt.contiguous()


def _index_differences(got, want, label):
    """Entries of the kernel's (j, i, kd) dump that differ from the plain
    fields on the card; any that do must stay within the bound the CPU
    tests hold the port's fields to against JAX (at most 1e-3 of the
    entries, each within +-1 or at a validity edge)."""
    differ = total = 0
    for name, a, b in zip(('j', 'i', 'kd'), got, want):
        bad = a != b
        differ += int(bad.sum())
        total += bad.numel()
        near = ((a - b).abs() <= 1) | (a == -1) | (b == -1)
        check(bool(near[bad].all()), f'{label}: {name} indices differ by '
              f'more than 1 off a validity edge')
    check(differ <= 1e-3 * total, f'{label}: {differ} of {total} index '
          f'entries differ')
    return differ, total


def _check_against(out32, out16, ref, label):
    """f32 within 1e-5 max|ref| + 1e-6, identical support, bf16 within 1
    ulp of the rounded f32 output; returns max |d|."""
    import torch

    err = float((out32 - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max()) + 1e-6
    check(err <= tol, f'{label}: {err} > {tol}')
    check(torch.equal(out32.ne(0).any(-1), ref.ne(0).any(-1)),
          f'{label}: kernel and plain support differ')
    rounded = out32.to(torch.bfloat16).float()
    _, exp = torch.frexp(rounded)
    ulp = torch.ldexp(torch.ones_like(rounded), exp - 8)
    check(float(((out16.float() - rounded).abs() - ulp).max()) <= 0,
          f'{label}: bf16 output off by more than 1 ulp')
    return err, tol


def phase_kernel_vs_plain(dev, card):
    """The fused kernel against its plain version at b1 and b4, ring rig
    and a rig moved per sample; then, at b4 on the ring rig, the
    fields-in entry against its plain version, and the times.  Returns
    the rows (max |d|, ms, plain ms, bound ms, bound_by) of the fused
    kernel and of the fields-in entry."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        cell_indices, gather_cells, geometry_fields, lss_sample,
        lss_sample_bev, lss_sample_bev_bytes, lss_sample_bev_reference,
        lss_sample_bytes, lss_sample_reference)
    from omnihd_scenes_tpu_torch.ops.lss_project import (camera_geometry,
                                                         sample_fields)
    from omnihd_scenes_tpu_torch.tools.roofline import bound

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for batch in (1, BATCH):
        for moved in (True, False):
            lss, g, rots, trans, minv, mt = _production_geometry(batch, dev,
                                                                 moved)
            sx = lss.cam_solve_x
            f_h, f_w = lss.feat_hw
            shape = (batch, len(sx), f_h, f_w)
            feat = torch.randn(shape + (lss.camC,), generator=gen,
                               device=dev).to(torch.bfloat16)
            depth = torch.softmax(torch.randn(shape + (lss.depth_bins,),
                                              generator=gen, device=dev),
                                  -1).to(torch.bfloat16)
            label = f'b{batch} {"moved" if moved else "ring"} rig'
            out32, idx = lss_sample_bev(feat, depth, minv, mt, g, sx,
                                        out_dtype=torch.float32, dump=True)
            out16 = lss_sample_bev(feat, depth, minv, mt, g, sx,
                                   out_dtype=torch.bfloat16)
            want_idx = cell_indices(*geometry_fields(minv, mt, g, sx), sx,
                                    g.ny, g.nx, lss.depth_bins)
            differ, total = _index_differences(idx, want_idx, label)
            # With identical indices this is lss_sample_bev_reference; else
            # the plain gather on the kernel's own indices.
            ref = gather_cells(feat, depth, *(idx if differ else want_idx),
                               torch.float32)
            torch.cuda.synchronize()
            err, tol = _check_against(out32, out16, ref, f'fused kernel '
                                      f'vs plain at {label}')
            worst = max(worst, err)
            support = ref.ne(0).any(-1)
            print(f'[3 kernel vs plain] fused, {label}: indices '
                  f'{"identical" if not differ else f"{differ} differ"} '
                  f'({total} (cell, camera, index) entries); max|d| '
                  f'{err:.3e} (tol {tol:.3e}), support '
                  f'{int(support.sum())}/{support.numel()} cells '
                  f'identical, bf16 within 1 ulp')
            del out32, out16, idx, want_idx, ref, support

    # b4, ring rig (the last case): the fields-in entry, then the times.
    fields = sample_fields(rots, trans, g, sx)
    kw = dict(solve_x=sx, ny=g.ny, nx=g.nx)
    args = (feat, depth, *fields)
    out32 = lss_sample(*args, out_dtype=torch.float32, **kw)
    out16 = lss_sample(*args, out_dtype=torch.bfloat16, **kw)
    ref = lss_sample_reference(*args, sx, g.ny, g.nx, torch.float32)
    torch.cuda.synchronize()
    f_err, _ = _check_against(out32, out16, ref, 'fields-in entry vs plain')
    del out32, out16, ref

    geo = (feat, depth, minv, mt, g, sx)
    ms = cuda_ms(lambda: lss_sample_bev(*geo, out_dtype=torch.bfloat16),
                 iters=20, warmup=3)
    stage_ms = cuda_ms(lambda: lss_sample_bev(
        feat, depth, *(t.contiguous() for t in camera_geometry(rots, trans)),
        g, sx, out_dtype=torch.bfloat16), iters=20, warmup=3)
    f_ms = cuda_ms(lambda: lss_sample(*args, out_dtype=torch.bfloat16, **kw),
                   iters=20, warmup=3)
    old_ms = cuda_ms(lambda: lss_sample(
        feat, depth, *sample_fields(rots, trans, g, sx),
        out_dtype=torch.bfloat16, **kw), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: lss_sample_bev_reference(*geo, torch.bfloat16),
                       iters=3, warmup=1)
    f_plain_ms = cuda_ms(lambda: lss_sample_reference(
        *args, sx, g.ny, g.nx, torch.bfloat16), iters=3, warmup=1)
    # Gathers: no arithmetic to speak of, so the bytes that this run's
    # indices make each function move (each needed element once) bound it.
    nbytes = lss_sample_bev_bytes(*geo, torch.bfloat16)
    bound_ms, bound_by = bound(0, 'bf16', nbytes)
    f_bytes = lss_sample_bytes(*args, sx, g.ny, g.nx, torch.bfloat16)
    f_bound, f_by = bound(0, 'bf16', f_bytes)
    print(f'[3 kernel vs plain] b{BATCH} bf16, ring rig: fused kernel '
          f'{ms:.4f} ms ({bound_ms / ms:.3f} of its {bound_ms:.4f} ms '
          f'{bound_by} bound, {nbytes / 1e9:.4f} GB), plain PyTorch '
          f'{plain_ms:.4f} ms; with camera_geometry (the serving stage) '
          f'{stage_ms:.4f} ms; the two-step path (sample_fields + the '
          f'fields-in entry) {old_ms:.4f} ms; the fields-in entry alone '
          f'{f_ms:.4f} ms ({f_bound / f_ms:.3f} of its {f_bound:.4f} ms '
          f'{f_by} bound, {f_bytes / 1e9:.4f} GB), its plain version '
          f'{f_plain_ms:.4f} ms, by CUDA events ({card})')
    return ((worst, ms, plain_ms, bound_ms, bound_by),
            (f_err, f_ms, f_plain_ms, f_bound, f_by))


def _small_config():
    from omnihd_scenes_tpu_torch import config as c

    pc_range = (-8.0, -8.0, -3.0, 8.0, 8.0, 5.0)
    return c.BEVFusionConfig(
        lss=c.LSSConfig(final_dim=(64, 112), camera_depth_range=(1.0, 9.0,
                                                                 1.0),
                        pc_range=pc_range, grid=2.0),
        pillars=c.PointPillarsConfig(
            point_cloud_range=pc_range, voxel_size=(1.0, 1.0, 8.0),
            pillar_impl='dense', bev_hw=(16, 16),
            anchor_ranges=tuple((-8.0, -8.0, z, 8.0, 8.0, z)
                                for z in (0.91, 1.142, 0.906, 1.516))))


def phase_small_parity(dev):
    import torch

    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    cfg = _small_config()
    sd = random_state_dict(cfg, seed=1)
    req = random_request(np.random.RandomState(1), cfg, batch=2)
    gpu = Predictor(cfg, sd, device=dev, dtype=torch.float32)
    cpu = Predictor(cfg, sd, device='cpu', dtype=torch.float32)
    out_g = {k: v.cpu() for k, v in gpu.forward(*req).items()}
    out_c = cpu.forward(*req)
    worst = 0.0
    for k in ('bev', 'cls_score', 'bbox_pred', 'dir_pred', 'depth'):
        err = float((out_g[k] - out_c[k]).abs().max())
        rel = err / float(out_c[k].abs().max())
        check(rel <= 1e-4, f'GPU vs CPU {k}: {rel:.3e} of max|ref|')
        worst = max(worst, rel)

    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)
    heads = [out_g[k].float() for k in ('cls_score', 'bbox_pred',
                                        'dir_pred')]
    dec_c = anchor_head_get_bboxes(*heads, cpu.anchors)
    dec_g = [t.cpu() for t in anchor_head_get_bboxes(
        *[h.to(dev) for h in heads], gpu.anchors)]
    valid = dec_c[3]
    check(int(valid.sum()) > 0, 'no box kept at small size')
    check(torch.equal(dec_g[3].sum(-1), valid.sum(-1)),
          'GPU and CPU NMS keep different numbers of boxes')
    row_err = max(kept_row_distance(dec_g, dec_c, s)
                  for s in range(valid.shape[0]))
    check(row_err <= 1e-5, f'GPU and CPU kept rows differ by {row_err}')
    print(f'[4 small-size parity] GPU f32 vs CPU f32 network outputs within '
          f'{worst:.3e} of max|ref|; decode + NMS keep the same '
          f'{int(valid.sum())} (box, score, label) rows within {row_err:.1e}')


def kept_row_distance(a, b, s):
    """Largest distance from a kept (box, score, label) row of decode ``a``
    to the nearest kept row of ``b`` and back, in sample ``s``, with box
    columns divided by their largest magnitude (at least 1).  The CPU and
    the GPU may round a sigmoid differently in the last bit, so two
    nearly tied scores can leave top-k in another order; kept rows are
    matched as multisets, not by position."""
    import torch

    rows = [torch.cat([boxes[s][valid[s]], scores[s][valid[s], None],
                       100.0 * labels[s][valid[s], None].float()], -1)
            for boxes, scores, labels, valid in (a, b)]
    gain = torch.cat([rows[1][:, :-2].abs().amax(0).clamp(min=1.0),
                      torch.ones(2)])
    d = ((rows[0][:, None] - rows[1][None]) / gain).abs().amax(-1)
    return float(max(d.min(1).values.max(), d.min(0).values.max()))


def phase_serving(dev, card, cfg, state_dict):
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                            lss_sample_bev)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    t0 = time.perf_counter()
    predictor = Predictor(cfg, state_dict, device=dev, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]

    counts, dev_ms, host_ms = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lss_sample_bev.launches = lss_sample.launches = 0
    for req in requests:
        t0 = time.perf_counter()
        start.record()
        boxes, scores, labels, valid = predictor(*req)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        counts.append(lss_sample_bev.launches)
        check(tuple(boxes.shape) == (BATCH, 500, 9)
              and tuple(scores.shape) == (BATCH, 500)
              and tuple(labels.shape) == (BATCH, 500),
              f'output shapes {boxes.shape} {scores.shape} {labels.shape}')
        check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
              'non-finite serving output')
    launches = (lss_sample_bev.launches, lss_sample.launches)
    check(counts == list(range(1, len(requests) + 1)),
          f'lss_sample_bev launches after each request {counts}, not one '
          f'per request')
    check(lss_sample.launches == 0, 'the serving path launched the '
          'fields-in entry')
    ms = float(np.mean(dev_ms[1:]))
    print(f'[5 serving] b{BATCH} x {N_TIMED} requests (+1 warm-up): '
          f'{ms:.2f} ms/request by CUDA events ({dev_ms[1:]}), host '
          f'{float(np.mean(host_ms[1:])):.2f} ms, {BATCH * 1e3 / ms:.2f} '
          f'samples/s ({card}); kept boxes {int(valid.sum())}; model setup '
          f'{setup_s:.1f} s; lss_sample_bev launches after each request '
          f'{counts}, fields-in entry 0')
    return launches, predictor, requests[-1], ms


def phase_bf16_vs_f32(dev, cfg, state_dict, predictor, request):
    """The timed bf16 network against an f32 Predictor on the same weights
    and request: head maps within HEAD_TOL of max|ref|, and at least
    BOX_MATCH of the kept bf16 boxes overlapping (rotated BEV IoU >=
    0.5) a kept f32 box of the same label."""
    import torch

    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor

    reference = Predictor(cfg, state_dict, device=dev, dtype=torch.float32)
    keys = ('bev', 'cls_score', 'bbox_pred', 'dir_pred')
    aspp_in = []
    hook = predictor.model.lss.depthnet.aspp.register_forward_hook(
        lambda module, args, out: aspp_in.append(args[0]))
    try:
        got = {k: v.float() for k, v in predictor.forward(*request).items()
               if k in keys}
    finally:
        hook.remove()
    want = reference.forward(*request)
    rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
           for k in keys}
    dec = [anchor_head_get_bboxes(*(out[k] for k in keys[1:]),
                                  reference.anchors)
           for out in (got, want)]
    (b16, _, l16, v16), (b32, _, l32, v32) = dec
    share = box_match(b16, l16, v16, b32, l32, v32)
    print(f'[6 bf16 vs f32] full-width b{BATCH}: head maps off by '
          + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|f32| (limit {HEAD_TOL}); kept boxes bf16 '
          f'{int(v16.sum())}, f32 {int(v32.sum())}, {share:.4f} of bf16 '
          f'matched (limit {BOX_MATCH})')
    check(all(v <= HEAD_TOL for v in rel.values()),
          f'bf16 head maps off the f32 reference: {rel}')
    check(int(v16.sum()) > 0 and share >= BOX_MATCH,
          f'bf16 kept boxes match f32 ones for only {share:.4f}')
    return aspp_in[0]


def box_match(boxes, labels, valid, ref_boxes, ref_labels, ref_valid):
    """Share of the kept boxes that overlap (rotated BEV IoU >= 0.5) a
    kept reference box of the same label."""
    from omnihd_scenes_tpu_torch.ops.boxes3d import rotated_iou_bev

    iou = rotated_iou_bev(boxes, ref_boxes)
    match = ((iou >= 0.5) & (labels[..., :, None] == ref_labels[..., None, :])
             & ref_valid[..., None, :]).any(-1)
    return float((match & valid).sum() / valid.sum().clamp(min=1))


def bf16_ulps(got, want):
    """Entry-wise distance in bf16 units in the last place."""
    import torch

    g = got.to(torch.bfloat16).view(torch.int16).int()
    w = want.to(torch.bfloat16).view(torch.int16).int()
    return (g - w).abs()


def _qconv_case(gen, dev, n, c, h, w, co):
    import torch

    x8 = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=dev,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    w8 = torch.randint(-127, 128, (co, 3, 3, c), generator=gen, device=dev,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    scale = torch.rand(co, generator=gen, device=dev) * 9e-6 + 1e-6
    shift = torch.randn(co, generator=gen, device=dev)
    return x8, w8, scale, shift


def _int_mm_ms(x8, w8):
    """``torch._int_mm`` of a pre-built s8 im2col matrix (M, 9C) by the
    weight (9C, Co): the same integer sums as the kernel without its
    epilogue; building the matrix is not timed.  None where cuBLASLt
    does not take the shape (M <= 16)."""
    import torch
    import torch.nn.functional as F

    n, c, h, w = x8.shape
    co = w8.shape[0]
    if n * h * w <= 16:
        return None
    xp = F.pad(x8.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(n * h * w, 9 * c)
    wk = w8.permute(0, 2, 3, 1).reshape(co, 9 * c).t()    # column-major
    ms = cuda_ms(lambda: torch._int_mm(cols, wk), iters=10, warmup=2)
    del cols, xp
    return ms


def _cudnn_bf16_ms(x, w, d=1, iters=10):
    """cuDNN's bf16 conv alone (channels_last), the same shape as a
    kernel call."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    xb = x.to(torch.bfloat16).contiguous(memory_format=cl)
    wb = w.to(torch.bfloat16).contiguous(memory_format=cl)
    with torch.inference_mode():
        return cuda_ms(lambda: F.conv2d(xb, wb, padding=d, dilation=d),
                       iters=iters, warmup=2)


def phase_qconv(dev, card):
    """The int8 kernel against its plain version at the tier's b4 shapes
    and the tiling's edge shapes; returns (max f32 |d|, kernel ms, plain
    ms, bound ms, bound_by, library ms) at the DepthNet shape."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.qconv import (qconv3x3,
                                                       qconv3x3_reference)
    from omnihd_scenes_tpu_torch.tools.roofline import bound, conv_cost

    gen = torch.Generator(device=dev).manual_seed(7)
    worst, first = 0.0, None
    shapes = [(name, shape, True) for name, shape in QCONV_SHAPES.items()]
    shapes += [(name, shape, False) for name, shape in QCONV_EDGES.items()]
    for name, ((n, c, h, w), co), b4 in shapes:
        args = _qconv_case(gen, dev, n, c, h, w, co)
        ref = qconv3x3_reference(*args, relu=True, out_dtype=torch.float32)
        got32 = qconv3x3(*args, relu=True, out_dtype=torch.float32)
        got16 = qconv3x3(*args, relu=True, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got32 - ref).abs()
        tol = 2.0 ** -22 * ref.abs() + 1e-30
        check(bool((err <= tol).all()), f'qconv f32 vs plain at {name}: '
              f'{float((err - tol).max())} over the bound')
        ulp = bf16_ulps(got16, ref)
        share = float((ulp > 0).float().mean())
        check(int(ulp.max()) <= 1 and share < 1e-3,
              f'qconv bf16 vs plain at {name}: {int(ulp.max())} ulp, '
              f'share {share}')
        worst = max(worst, float(err.max()))
        del ref, got32, got16
        ms = cuda_ms(lambda: qconv3x3(*args, relu=True), iters=10, warmup=2)
        ops, nbytes = conv_cost(n, c, h, w, co, 1, 2)
        bound_ms, bound_by = bound(ops, 'int8', nbytes)
        int_mm_ms = _int_mm_ms(args[0], args[1])
        cudnn_ms = _cudnn_bf16_ms(args[0], args[1])
        plain = ''
        if b4:
            plain_ms = cuda_ms(lambda: qconv3x3_reference(*args, relu=True),
                               iters=2, warmup=1)
            plain = f', plain (f64) {plain_ms:.4f} ms'
            if first is None:
                first = (ms, plain_ms, bound_ms, bound_by, int_mm_ms)
        lib = 'n/a (M <= 16)' if int_mm_ms is None else f'{int_mm_ms:.4f} ms'
        print(f'[7 qconv vs plain] {name} ({n}, {c}, {h}, {w}) -> {co}: f32 '
              f'max|d| {float(err.max()):.3e}, bf16 max {int(ulp.max())} '
              f'ulp on {share:.2e} of entries; kernel {ms:.4f} ms '
              f'({ops / ms / 1e9:.1f} TOP/s, {bound_ms / ms:.3f} of its '
              f'{bound_ms:.4f} ms {bound_by} bound){plain}; torch._int_mm '
              f'on im2col {lib}, cuDNN bf16 conv {cudnn_ms:.4f} ms ({card})')
        del args
    return (worst, *first)


def _bconv_weight(gen, dev, c, co):
    import torch

    return (torch.randn((co, 3, 3, c), generator=gen, device=dev)
            * c ** -0.5 / 3).to(torch.bfloat16).permute(0, 3, 1, 2)


def _bconv_case(gen, dev, n, c, h, w, co):
    import torch

    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    scale = torch.rand(co, generator=gen, device=dev) + 0.5
    shift = torch.randn(co, generator=gen, device=dev) * 0.1
    return x, _bconv_weight(gen, dev, c, co), scale, shift


def _bconv_check(got, x, wt, scale, shift, relu, d, label):
    """bf16 ``got`` within 1 ulp of the f32 conv (TF32 off) rounded, + 1e-5
    max|ref| for cancellation; returns (max |d|, share of entries off the
    rounded f32 result)."""
    import torch
    import torch.nn.functional as F

    ref = F.conv2d(x.float(), wt.float(), padding=d, dilation=d)
    ref = ref * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    ref = ref.clamp_min(0.0) if relu else ref
    torch.cuda.synchronize()
    rounded = ref.to(torch.bfloat16).float()
    _, exp = torch.frexp(rounded)
    ulp = torch.ldexp(torch.ones_like(rounded), exp - 8)
    diff = (got.float() - rounded).abs()
    slack = float((diff - ulp).max())
    allow = 1e-5 * float(ref.abs().max())
    check(slack <= allow, f'bconv {label}: {slack} over 1 ulp (allowed '
          f'{allow})')
    return float(diff.max()), float((diff > 0).float().mean())


def phase_bconv(dev, card, aspp, aspp_in):
    """The bf16 kernel against its plain version and cuDNN at the ASPP
    shape and the tiling's edge shapes; then its entry point on the ASPP
    dilated branches.  Returns (max bf16 |d|, kernel ms, plain ms, bound
    ms, bound_by, cuDNN conv ms, all at d = 6, entry-point launches)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from omnihd_scenes_tpu_torch.kernels.bconv import (bconv3x3,
                                                       bconv3x3_reference)
    from omnihd_scenes_tpu_torch.tools.roofline import bound, conv_cost

    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(8)
    (n, c, h, w), co = BCONV_SHAPE
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    scale = torch.rand(co, generator=gen, device=dev) + 0.5
    shift = torch.randn(co, generator=gen, device=dev) * 0.1
    bn_scale = scale / torch.sqrt(torch.ones_like(scale) + 1e-5)
    ops, nbytes = conv_cost(n, c, h, w, co, 2, 2)
    bound_ms, bound_by = bound(ops, 'bf16', nbytes)
    worst, times = 0.0, {}
    for d in BCONV_DILATIONS:
        wt = _bconv_weight(gen, dev, c, co)
        conv = nn.Conv2d(c, co, 3, padding=d, dilation=d, bias=False)
        bn = nn.BatchNorm2d(co, eps=1e-5)
        with torch.no_grad():
            conv.weight.copy_(wt)
            bn.weight.copy_(scale)
            bn.bias.copy_(shift)
        cudnn = nn.Sequential(conv, bn, nn.ReLU()).to(
            device=dev, dtype=torch.bfloat16, memory_format=cl).eval()
        for relu in (True, False):
            got = bconv3x3(x, wt, bn_scale, shift, relu=relu, dilation=d)
            err, share = _bconv_check(got, x, wt, bn_scale, shift, relu, d,
                                      f'd={d} relu={relu}')
            worst = max(worst, err)
            print(f'[8 bconv vs plain] d={d} relu={relu}: max|d| {err:.3e}, '
                  f'within 1 ulp; {share:.4f} of entries differ from the '
                  f'rounded f32 sum (summation order)')
            del got
        with torch.inference_mode():
            ms = cuda_ms(lambda: bconv3x3(x, wt, bn_scale, shift,
                                          dilation=d), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: bconv3x3_reference(
                x, wt, bn_scale, shift, dilation=d), iters=3, warmup=1)
            fused_ms = cuda_ms(lambda: cudnn(x), iters=10, warmup=2)
        conv_ms = _cudnn_bf16_ms(x, wt, d)
        times[d] = (ms, plain_ms, conv_ms)
        print(f'[8 bconv vs plain] d={d} ({n}, {c}, {h}, {w}) -> {co}: '
              f'kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, '
              f'{bound_ms / ms:.3f} of its {bound_ms:.4f} ms {bound_by} '
              f'bound), plain (f32 conv, TF32 off) {plain_ms:.4f} ms, cuDNN '
              f'bf16 conv {conv_ms:.4f} ms, cuDNN bf16 conv + BN + ReLU '
              f'{fused_ms:.4f} ms ({card})')
        del wt, conv, bn, cudnn

    for name, ((n, c, h, w), co, d) in BCONV_EDGES.items():
        ex, ewt, escale, eshift = _bconv_case(gen, dev, n, c, h, w, co)
        got = bconv3x3(ex, ewt, escale, eshift, relu=True, dilation=d)
        err, share = _bconv_check(got, ex, ewt, escale, eshift, True, d,
                                  name)
        worst = max(worst, err)
        ms = cuda_ms(lambda: bconv3x3(ex, ewt, escale, eshift, dilation=d),
                     iters=10, warmup=2)
        e_ops, e_bytes = conv_cost(n, c, h, w, co, 2, 2)
        e_bound, e_by = bound(e_ops, 'bf16', e_bytes)
        print(f'[8 bconv vs plain] {name} ({n}, {c}, {h}, {w}) -> {co}, '
              f'd={d}: max|d| {err:.3e}, within 1 ulp ({share:.4f} of '
              f'entries off the rounded f32 sum); kernel {ms:.4f} ms '
              f'({e_ops / ms / 1e9:.1f} TFLOP/s, {e_bound / ms:.3f} of its '
              f'{e_bound:.4f} ms {e_by} bound), cuDNN bf16 conv '
              f'{_cudnn_bf16_ms(ex, ewt, d):.4f} ms ({card})')
        del ex, ewt, got

    # The entry point on the serving network's ASPP dilated branches.
    bconv3x3.launches = 0
    rel = []
    with torch.inference_mode():
        for i, d in enumerate(aspp.DILATIONS):
            if d == 1:
                continue                 # the d = 1 branch is a 1x1 conv
            conv, bn = aspp.convs[i], aspp.bns[i]
            s = bn.weight.float() / torch.sqrt(bn.running_var.float()
                                               + bn.eps)
            t = bn.bias.float() - bn.running_mean.float() * s
            got = bconv3x3(aspp_in, conv.weight, s, t, relu=True,
                           dilation=d)
            want = F.relu(bn(conv(aspp_in)))
            rel.append(float((got.float() - want.float()).abs().max()
                             / want.float().abs().max()))
    launches = bconv3x3.launches
    check(launches == 3, f'bconv entry point launched {launches} times')
    check(max(rel) <= 2e-2, f'bconv ASPP branches vs the model: {rel}')
    print(f'[8 bconv entry point] ASPP branches d=6/12/18 of the served '
          f'request, {tuple(aspp_in.shape)}: {launches} launches, off the '
          f'model\'s bf16 conv + BN + ReLU by {rel} of max|model| (bf16 '
          f'rounding of the unfused conv output)')
    ms, plain_ms, conv_ms = times[6]
    return worst, ms, plain_ms, bound_ms, bound_by, conv_ms, launches


def _eligible_layers(model):
    from omnihd_scenes_tpu_torch.models.quant import QConv2d, qconv_eligible

    return sum(isinstance(m, QConv2d) and qconv_eligible(m)
               for m in model.modules())


def phase_int8_small(dev):
    """GPU int8 (kernel route) against CPU int8 (plain route) at a small
    size: every quantized conv on the same input, then the network.

    Layer by layer the two routes compute the same codes and the same
    integer sums, so an eligible layer's output must agree within one f32
    rounding and the others within f32 summation order and cuDNN's choice
    of f32 conv algorithm (1e-5).  The
    network outputs differ more: a random-weight int8 network turns any
    f32-level difference (here cuDNN's summation order) into codes that
    flip at .5 and cascade, so the limit is set from the CPU path's own
    response to a one-ulp change of the input images, printed beside it.
    """
    import torch

    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.models.quant import QConv2d, qconv_eligible
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    keys = ('bev', 'cls_score', 'bbox_pred', 'dir_pred', 'depth')
    cfg = _small_config()
    sd = random_state_dict(cfg, seed=1)
    req = random_request(np.random.RandomState(2), cfg, batch=2)
    quant = calibrate(cfg, sd, [req], device='cpu', dtype=torch.float32)
    cpu = Predictor(cfg, sd, device='cpu', dtype=torch.float32,
                    quant_state=quant)
    gpu = Predictor(cfg, sd, device=dev, dtype=torch.float32,
                    quant_state=quant)
    eligible = _eligible_layers(gpu.model)
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen[name] = (args[0].cpu(), out.cpu())
        return hook

    hooks = [m.register_forward_hook(keep(name))
             for name, m in gpu.model.named_modules()
             if isinstance(m, QConv2d)]
    qconv3x3.launches = 0
    try:
        out_g = {k: v.cpu() for k, v in gpu.forward(*req).items()}
    finally:
        for h in hooks:
            h.remove()
    launches = qconv3x3.launches
    check(launches == eligible > 0, f'qconv launched {launches} times for '
          f'{eligible} eligible layers')

    cpu_layers = dict(cpu.model.named_modules())
    layer_err = {True: 0.0, False: 0.0}
    with torch.inference_mode():
        for name, (x, y_gpu) in seen.items():
            y_cpu = cpu_layers[name](x)
            rel = float((y_gpu - y_cpu).abs().max() / y_cpu.abs().max())
            kind = qconv_eligible(cpu_layers[name])
            layer_err[kind] = max(layer_err[kind], rel)
    check(layer_err[True] <= 2.0 ** -22 and layer_err[False] <= 1e-5,
          f'int8 layers on the same input differ: {layer_err}')

    out_c = cpu.forward(*req)
    nudged = list(req)
    nudged[2] = req[2] * np.float32(1 + 2.0 ** -23)
    out_n = cpu.forward(*nudged)
    rel, floor = ({k: float((o[k] - out_c[k]).abs().max()
                            / out_c[k].abs().max()) for k in keys}
                  for o in (out_g, out_n))
    print(f'[9 int8 small parity] {len(seen)} quantized convs, GPU vs CPU '
          f'on the same input: eligible (kernel) {layer_err[True]:.3e}, '
          f'others {layer_err[False]:.3e} of max|ref|; qconv launches '
          f'{launches} for {eligible} eligible layers')
    print(f'[9 int8 small parity] network, GPU int8 f32 vs CPU int8 f32 on '
          f'a CPU-calibrated quant state: ' + ', '.join(
              f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|ref| (limit {INT8_SMALL_TOL}); the CPU path itself '
          f'moves by ' + ', '.join(f'{k} {v:.3e}' for k, v in floor.items())
          + ' when the images change by one ulp')
    check(all(v <= INT8_SMALL_TOL for v in rel.values()),
          f'GPU int8 off the CPU int8 path: {rel}')


def phase_int8_serving(dev, card, cfg, state_dict, bf16_ms):
    """Returns (qconv launches, the int8 Predictor, the last request)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.bconv import bconv3x3
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                            lss_sample_bev)
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    rng = np.random.RandomState(3)
    t0 = time.perf_counter()
    quant = calibrate(cfg, state_dict, [random_request(rng, cfg, BATCH)],
                      device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    predictor = Predictor(cfg, state_dict, device=dev, dtype=torch.bfloat16,
                          quant_state=quant)
    eligible = _eligible_layers(predictor.model)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]

    counts, dev_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lss_sample_bev.launches = lss_sample.launches = 0
    qconv3x3.launches = bconv3x3.launches = 0
    for req in requests:
        start.record()
        boxes, scores, labels, valid = predictor(*req)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        counts.append((qconv3x3.launches, lss_sample_bev.launches))
        check(tuple(boxes.shape) == (BATCH, 500, 9)
              and tuple(scores.shape) == (BATCH, 500)
              and tuple(labels.shape) == (BATCH, 500),
              f'int8 output shapes {boxes.shape} {scores.shape} '
              f'{labels.shape}')
        check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
              'non-finite int8 serving output')
    q_launches = qconv3x3.launches
    check(q_launches == eligible * len(requests) and eligible > 0,
          f'qconv launches {q_launches} != {eligible} eligible layers x '
          f'{len(requests)} requests')
    check([c[1] for c in counts] == list(range(1, len(requests) + 1)),
          f'lss_sample_bev launches after each int8 request {counts}, not '
          f'one per request')
    check(lss_sample.launches == 0, 'the int8 path launched the fields-in '
          'entry')
    check(bconv3x3.launches == 0, 'the int8 path launched bconv')
    ms = float(np.mean(dev_ms[1:]))
    print(f'[10 int8 serving] b{BATCH} x {N_TIMED} requests (+1 warm-up): '
          f'{ms:.2f} ms/request by CUDA events ({dev_ms[1:]}), '
          f'{BATCH * 1e3 / ms:.2f} samples/s, against bf16 {bf16_ms:.2f} '
          f'ms/request = {BATCH * 1e3 / bf16_ms:.2f} samples/s ({card}); '
          f'kept boxes {int(valid.sum())}; calibrate + freeze {calib_s:.2f} '
          f's; {eligible} eligible layers, (qconv, lss_sample_bev) '
          f'launches after each request {counts}, fields-in entry 0')
    return q_launches, predictor, requests[-1]


def phase_int8_vs_bf16(bf16, int8, request):
    import torch

    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)

    keys = ('bev', 'cls_score', 'bbox_pred', 'dir_pred')
    got = {k: v.float() for k, v in int8.forward(*request).items()
           if k in keys}
    want = {k: v.float() for k, v in bf16.forward(*request).items()
            if k in keys}
    rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
           for k in keys}
    (b8, _, l8, v8), (b16, _, l16, v16) = [
        anchor_head_get_bboxes(*(out[k] for k in keys[1:]), bf16.anchors)
        for out in (got, want)]
    share = box_match(b8, l8, v8, b16, l16, v16)
    print(f'[11 int8 vs bf16] full-width b{BATCH}, random weights: head '
          f'maps off by ' + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|bf16| (limit {INT8_HEAD_TOL}); kept boxes int8 '
          f'{int(v8.sum())}, bf16 {int(v16.sum())}, {share:.4f} of int8 '
          f'matched (limit {INT8_BOX_MATCH})')
    check(all(v <= INT8_HEAD_TOL for v in rel.values()),
          f'int8 head maps off the bf16 ones: {rel}')
    check(int(v8.sum()) > 0 and share >= INT8_BOX_MATCH,
          f'int8 kept boxes match bf16 ones for only {share:.4f}')


def main():
    card = phase_device()
    import torch

    from omnihd_scenes_tpu_torch.config import serving_config
    from omnihd_scenes_tpu_torch.serve.synthetic import random_state_dict

    dev = torch.device('cuda', 0)
    phase_build()
    lss_row, fields_row = phase_kernel_vs_plain(dev, card)
    phase_small_parity(dev)
    cfg = serving_config()
    state_dict = random_state_dict(cfg, seed=0)
    (launches, fields_launches), predictor, request, bf16_ms = \
        phase_serving(dev, card, cfg, state_dict)
    aspp_in = phase_bf16_vs_f32(dev, cfg, state_dict, predictor, request)
    q_row = phase_qconv(dev, card)
    *b_row, b_launches = phase_bconv(
        dev, card, predictor.model.lss.depthnet.aspp, aspp_in)
    del aspp_in
    phase_int8_small(dev)
    # The int8 tier's other convs are f32 convs of int8 codes, which TF32
    # holds exactly, so serve with PyTorch's default (TF32 on for cuDNN):
    # it changes only the summation order.  The parity phases keep it off.
    torch.backends.cudnn.allow_tf32 = True
    q_launches, int8, int8_request = phase_int8_serving(
        dev, card, cfg, state_dict, bf16_ms)
    torch.backends.cudnn.allow_tf32 = False
    phase_int8_vs_bf16(predictor, int8, int8_request)
    # (source, launches, max |d|, ms, plain ms, bound ms, bound_by, library
    # ms): lss_sample is the fused kernel (launches of the bf16 serving
    # path; the int8 one launched it once per request too) at b4, its
    # fields-in entry (on no serving path) at b4, qconv at the DepthNet
    # block (library: _int_mm on im2col), bconv at d = 6 (library: cuDNN's
    # bf16 conv).
    rows = {'lss_sample': ('lss_sample', launches, *lss_row, None),
            'lss_sample_fields_in': ('lss_sample', fields_launches,
                                     *fields_row, None),
            'qconv': ('qconv', q_launches, *q_row),
            'bconv': ('bconv', b_launches, *b_row)}
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'{CSRC}{src}.cu',
        'replaces': KERNEL_REPLACES[name][0],
        **({'also_replaces': KERNEL_REPLACES[name][1]}
           if len(KERNEL_REPLACES[name]) > 1 else {}),
        'launches': n, 'max_abs_err': e, 'ms': t, 'plain_ms': pt,
        'bound_ms': bt, 'bound_by': by, 'library_ms': lib}
        for name, (src, n, e, t, pt, bt, by, lib) in rows.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
