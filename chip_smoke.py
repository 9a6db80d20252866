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
10b. int8 exactness at full width: on the last timed request, each of
   the tier's convs outside ``qconv`` (f32 convs of int8 codes, TF32 on
   as serving runs them) against exact int32 sums (``torch._int_mm`` on
   an s8 im2col, phase 7's yardstick; JAX sums them in int32): every
   entry equal; prints the worst layer, its largest sum and the largest
   sum of |x w| any partial sum can reach;
11. int8 vs bf16 on the last timed request: head maps within
   INT8_HEAD_TOL of max|bf16|, at least INT8_BOX_MATCH of the kept int8
   boxes overlapping a kept bf16 box of the same label;
12. the LSS backward kernels (``lss_sample_bev_backward``, the gradient
   of the view transform for feat and depth, pixel-major) vs their plain
   version (an ``index_add_`` scatter) at the production shapes, b1 and
   b4, ring and moved rigs, bf16 and f32: two launches bitwise equal;
   within 1e-5 max|ref| (bf16: plus 1 ulp) of the plain version on the
   card, whose CUDA ``index_add_`` adds with atomics; at b1 d feat
   bit-equal to the plain version run on the CPU (``index_add_`` in
   index order, the kernel's order) on the card's indices; at b4 bf16
   (the training dtype) its time beside the plain version and the bound
   of ``lss_sample_bev_backward_cost``, its steps (count, cumsum, fill +
   gather), and the previous design (f32 atomics, kept in the source as a
   yardstick) split into memset, kernel and casts;
13. sorted pillars served: a ``pillar_impl='sorted'`` Predictor, f32 on
   the GPU against the same on the CPU, one b4 request at small size:
   network outputs within 1e-4 of max|ref|, the same kept rows;
14. one small f32 train step (forward, loss, backward, AdamW) on the GPU
   against the CPU, TF32 off, with every BatchNorm in train mode and its
   bias at +4 (ReLU inputs away from 0, where a rounding would send one
   down the other branch on the other device: with the backbone frozen
   and biases at 0 the f32 gradient of this step is 5e-3 off its own f64
   value on the CPU, with this setting 4e-6): loss within 1e-5, the whole
   gradient within 1e-4 in relative L2 norm, BatchNorm statistics within
   1e-4 of max|ref|, parameters within 2.5 learning rates (Adam's first
   step moves each by about one);
15. training at full width: the shipped ``configs/bevfusion.py`` model
   (``BEVFusionConfig()``: sorted pillars, the sampling splat, DepthNet)
   under the bf16 policy, f32 master weights, AdamW + clip 35, at b1 and
   b4: 1 warm-up and 3 timed steps of fresh synthetic batches with depth
   targets (on the card before the timing), CUDA events per step;
   ms/step, samples/s, peak GiB, finite losses; the LSS forward and
   backward kernels launch exactly once per step, and DepthNet's
   ``depth_conv`` gets a nonzero gradient;
16. the pillar families at a small size (16x16 pillars, SECOND
   64/128/256, FPN 3x128), f32 on the GPU against the CPU, TF32 off:
   PointPillars radar (sorted and dense), RadarPillarNet and LiDAR (4
   dims, 64 points per pillar); head maps within 1e-4 of max|ref| and the
   same kept rows after decode + NMS of the same maps (weights as drawn),
   one train step's loss within 1e-5 and gradient within 1e-4 (relative
   L2; BatchNorm biases +4); no LSS kernel launches;
17. full-width pillar training and inference in each shipped
   configuration (``configs/pointpillars_radar.py``, ``radarpillarnet.py``,
   ``pointpillars_lidar.py``: 320x480 at 0.25 m, 30,000 pillars, SECOND
   64/128/256, FPN 3x128, 307,200 anchors) built by
   ``build_model_from_cfg``: b8 synthetic batches (radar 40,000 points x
   8 dims, LiDAR 120,000 x 4, 64 GT boxes): one b8 eval-mode forward +
   decode + NMS on the seeded weights (ms, peak GiB, finite boxes), then
   1 warm-up and 3 timed f32 steps (ms/step, peak GiB, finite and falling
   losses);
18. the LSS camera-only model of ``configs/lss_camera.py`` at full width:
   1 + 3 b4 bf16-policy train steps as phase 15 (one LSS forward and one
   backward launch per step, finite and falling losses, ms, peak GiB) and
   one b4 bf16 request (one ``lss_sample_bev`` launch, ms);
19. the CLIs on the card: a synthetic dataroot written without images,
   its infos, ``tools.train configs/synthetic/pointpillars_radar_synth.py``
   and ``tools.test ... --eval`` as subprocesses (exit codes checked,
   finite mAP and NOS in ``metrics.json``), then the micro-train recipe
   of ``tests/test_learning_quick.py`` (``micro_train``) on the card:
   mAP > 0.5 and NOS > 0.45, with its seconds.

The line before the last is a JSON object of the kernels (launches on
the main paths: the serving path's for the forward kernels, the b4
training phase's for the LSS backward, and for the LSS kernels also the
camera-only path's (phase 18), error against the plain version, kernel / plain /
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
    # The splat's backward is the einsum VJP inside the custom_vjp of
    # pallas_splat.py:246-261, not a Pallas kernel.
    'lss_sample_backward': ('omnihd_scenes_tpu/ops/pallas_splat.py:246',),
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
TRAIN_BATCHES = (1, 4)
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


def _conv_exactness(m, x):
    """One int8 conv outside ``qconv`` on its input ``x``: the f32 conv of
    the int8 codes as ``QConv2d._int8`` runs it, against its exact int32
    sums (``torch._int_mm`` on an s8 im2col, K and Co padded to multiples
    of 8, a few images at a time).  Returns (entries that differ, max
    |exact sum|, max sum of |x w|: the most any partial sum can reach)."""
    import torch
    import torch.nn.functional as F

    from omnihd_scenes_tpu_torch.ops.qconv import quantize_act

    check(m.groups == 1, 'grouped int8 conv')
    x8, _ = quantize_act(x, m.act_amax)
    y = F.conv2d(x8.float(), m.w8.float(), None, m.stride, m.padding,
                 m.dilation, m.groups)
    co, c, kh, kw = m.w8.shape
    k = c * kh * kw
    kp, cop = -(-k // 8) * 8, -(-co // 8) * 8
    w = torch.zeros((cop, kp), dtype=torch.int8, device=x.device)
    w[:co, :k] = m.w8.contiguous().reshape(co, k)
    n, _, ho, wo = y.shape
    per = max(1, 2 ** 30 // (4 * k * ho * wo))
    bad = top = reach = 0
    for i in range(0, n, per):
        cols = F.unfold(x8[i:i + per].float(), (kh, kw), m.dilation,
                        m.padding, m.stride)
        cols = F.pad(cols.transpose(1, 2).reshape(-1, k).to(torch.int8),
                     (0, kp - k))
        exact = torch._int_mm(cols, w.t())[:, :co]
        reach = max(reach, int(torch._int_mm(cols.abs(), w.abs().t()).max()))
        exact = exact.view(-1, ho * wo, co).transpose(1, 2).reshape(
            -1, co, ho, wo)
        bad += int((y[i:i + per].double() != exact.double()).sum())
        top = max(top, int(exact.abs().max()))
    return bad, top, reach


def phase_int8_exact(int8, request):
    """Each int8 conv outside ``qconv`` of one full-width b4 int8 request,
    under serving's settings (TF32 on), against exact int32 sums."""
    import torch

    from omnihd_scenes_tpu_torch.models.quant import QConv2d, qconv_eligible

    seen = {}

    def hook(module, args, out, name):
        seen[name] = _conv_exactness(module, args[0])

    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: hook(mod, args, out, name))
        for name, m in int8.model.named_modules()
        if isinstance(m, QConv2d) and not qconv_eligible(m)]
    try:
        int8.forward(*request)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(seen) == len(hooks) > 0, f'{len(seen)} of {len(hooks)} int8 '
          f'convs outside qconv ran')
    worst = max(seen, key=lambda k: (seen[k][0], seen[k][2]))
    inexact = [k for k, v in seen.items() if v[0]]
    print(f'[10b int8 exactness] {len(seen)} int8 convs outside qconv, one '
          f'full-width b{BATCH} request, TF32 on (serving): '
          f'{len(seen) - len(inexact)} exact against int32 sums '
          f'(torch._int_mm on im2col); worst layer {worst}: '
          f'{seen[worst][0]} entries off, |sum| up to {seen[worst][1]}, sum '
          f'of |x w| up to {seen[worst][2]} (2^24 = {2 ** 24}); largest '
          f'|sum| of any layer {max(v[1] for v in seen.values())}, largest '
          f'sum of |x w| {max(v[2] for v in seen.values())}')
    check(not inexact, f'int8 convs not exact: {inexact}')


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


def _old_backward_split(args, iters=20, warmup=3):
    """The previous design of the backward (kept in ``lss_sample.cu`` as
    ``lss_sample_bev_backward_atomic``) on ``args``, by CUDA events per
    step: (zero-filling two f32 buffers, the atomic kernel, the casts to
    the inputs' dtype), mean ms."""
    import torch

    from omnihd_scenes_tpu_torch.kernels import lss_sample as kern

    grad, feat, depth, minv, mt, g, sx = args
    dev = feat.device
    fn = kern._kernel('lss_sample_bev_backward_atomic')
    tables = kern._device_tables(g.args, dev)
    shape = (kern._mask(sx), *feat.shape, depth.shape[-1], g.nz, g.ny, g.nx,
             *(float(v) for v in kern._geom_consts(g)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = np.zeros(3)
    for it in range(warmup + iters):
        ev[0].record()
        dfeat = torch.zeros(feat.shape, dtype=torch.float32, device=dev)
        ddepth = torch.zeros(depth.shape, dtype=torch.float32, device=dev)
        ev[1].record()
        kern._launch('lss_sample_bev_backward_atomic', fn, grad.data_ptr(),
                     feat.data_ptr(), depth.data_ptr(), minv.data_ptr(),
                     mt.data_ptr(), tables.data_ptr(), dfeat.data_ptr(),
                     ddepth.data_ptr(), kern._DTYPE_CODES[feat.dtype],
                     *shape, stream)
        ev[2].record()
        dfeat.to(feat.dtype), ddepth.to(depth.dtype)
        ev[3].record()
        torch.cuda.synchronize()
        if it >= warmup:
            parts += [ev[k].elapsed_time(ev[k + 1]) for k in range(3)]
    return parts / iters


def _new_backward_split(args, iters=20, warmup=3):
    """The steps of ``lss_sample_bev_backward`` on ``args`` (its wrapper's
    calls, unrolled), by CUDA events per step: (zeroing the histogram +
    the count kernel, ``torch.cumsum``, the fill + gather kernels), mean
    ms."""
    import torch

    from omnihd_scenes_tpu_torch.kernels import lss_sample as kern

    grad, feat, depth, minv, mt, g, sx = args
    dev = feat.device
    counts, ends, keys, ordered = kern._backward_scratch(feat.shape, g, dev)
    dfeat, ddepth = torch.empty_like(feat), torch.empty_like(depth)
    tables = kern._device_tables(g.args, dev)
    shape = (kern._mask(sx), *feat.shape, depth.shape[-1], g.nz, g.ny, g.nx,
             *(float(v) for v in kern._geom_consts(g)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = np.zeros(3)
    for it in range(warmup + iters):
        ev[0].record()
        kern._launch('count', kern._kernel('lss_sample_bev_backward_count'),
                     minv.data_ptr(), mt.data_ptr(), tables.data_ptr(),
                     counts.data_ptr(), *shape, stream)
        ev[1].record()
        torch.cumsum(counts, 0, dtype=torch.int32, out=ends)
        ev[2].record()
        kern._launch('fill + gather', kern._kernel('lss_sample_bev_backward'),
                     grad.data_ptr(), feat.data_ptr(), depth.data_ptr(),
                     minv.data_ptr(), mt.data_ptr(), tables.data_ptr(),
                     counts.data_ptr(), ends.data_ptr(), keys.data_ptr(),
                     ordered.data_ptr(), dfeat.data_ptr(), ddepth.data_ptr(),
                     kern._DTYPE_CODES[feat.dtype], *shape, stream)
        ev[3].record()
        torch.cuda.synchronize()
        if it >= warmup:
            parts += [ev[k].elapsed_time(ev[k + 1]) for k in range(3)]
    got = kern.lss_sample_bev_backward(grad, feat, depth, minv, mt, g, sx)
    check(torch.equal(dfeat, got[0]) and torch.equal(ddepth, got[1]),
          'the unrolled backward differs from its wrapper')
    return parts / iters


def _backward_tolerance(a, b):
    """|a - b| <= 1e-5 max|b|, plus 1 ulp of b where b is bf16."""
    import torch

    slack = 1e-5 * float(b.float().abs().max())
    if b.dtype == torch.bfloat16:
        _, exp = torch.frexp(b.float())
        slack = slack + torch.ldexp(torch.ones_like(b.float()), exp - 8)
    return bool(((a.float() - b.float()).abs() <= slack).all())


def phase_backward(dev, card):
    """The LSS backward kernel at b1 and b4, ring rig and a rig moved per
    sample, bf16 and f32: two launches bitwise equal, within the stated
    tolerance of the plain version on the card, and at b1 its d feat
    bit-equal to the plain version run on the CPU on the card's indices;
    then at b4 bf16 on the ring rig its time, its steps, and the previous
    design's split.  Returns (max |d|, ms, plain ms, bound ms,
    bound_by)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        cell_indices, geometry_fields, lss_sample_bev_backward,
        lss_sample_bev_backward_cost, lss_sample_bev_backward_reference,
        scatter_cells)
    from omnihd_scenes_tpu_torch.tools.roofline import bound

    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0.0
    for batch in (1, BATCH):
        for moved in (True, False):
            lss, g, _, _, minv, mt = _production_geometry(batch, dev, moved)
            sx = lss.cam_solve_x
            shape = (batch, len(sx)) + tuple(lss.feat_hw)
            label = f'b{batch} {"moved" if moved else "ring"} rig'
            for dtype in (torch.bfloat16, torch.float32):
                feat = torch.randn(shape + (lss.camC,), generator=gen,
                                   device=dev).to(dtype)
                depth = torch.softmax(torch.randn(
                    shape + (lss.depth_bins,), generator=gen, device=dev),
                    -1).to(dtype)
                grad = torch.randn((batch, g.ny, g.nx, g.nz, lss.camC),
                                   generator=gen, device=dev).to(dtype)
                args = (grad, feat, depth, minv, mt, g, sx)
                got = lss_sample_bev_backward(*args)
                again = lss_sample_bev_backward(*args)
                check(torch.equal(got[0], again[0])
                      and torch.equal(got[1], again[1]),
                      f'backward at {label} {dtype}: two launches differ')
                want = lss_sample_bev_backward_reference(*args)
                rel = []
                for name, a, b in zip(('dfeat', 'ddepth'), got, want):
                    check(a.dtype == b.dtype and _backward_tolerance(a, b),
                          f'backward {name} off the plain version at '
                          f'{label} {dtype}')
                    err = float((a.float() - b.float()).abs().max())
                    worst = max(worst, err)
                    rel.append(err / float(b.float().abs().max()))
                exact = ''
                if batch == 1:
                    idx = cell_indices(*geometry_fields(minv, mt, g, sx), sx,
                                       g.ny, g.nx, lss.depth_bins)
                    cpu = scatter_cells(*(t.cpu() for t in (grad, feat,
                                                            depth, *idx)))
                    check(torch.equal(got[0].cpu(), cpu[0])
                          and _backward_tolerance(got[1].cpu(), cpu[1]),
                          f'backward at {label} {dtype} off the plain '
                          f'version on the CPU')
                    exact = ('; d feat bit-equal to the plain version run '
                             'on the CPU on these indices')
                print(f'[12 backward vs plain] {label}, {dtype}: two '
                      f'launches bitwise equal; against the plain version '
                      f'on the card (CUDA index_add_) dfeat {rel[0]:.3e}, '
                      f'ddepth {rel[1]:.3e} of max|ref|{exact}')
                del got, again, want
    # b4, ring rig, bf16 (the last case's geometry, the training dtype).
    feat, depth, grad = (t.to(torch.bfloat16) for t in (feat, depth, grad))
    args = (grad, feat, depth, minv, mt, g, sx)
    ms = cuda_ms(lambda: lss_sample_bev_backward(*args), iters=20, warmup=3)
    old = _old_backward_split(args)
    ms_again = cuda_ms(lambda: lss_sample_bev_backward(*args), iters=20,
                       warmup=3)
    steps = _new_backward_split(args)
    plain_ms = cuda_ms(lambda: lss_sample_bev_backward_reference(*args),
                       iters=3, warmup=1)
    ops, nbytes = lss_sample_bev_backward_cost(*args)
    bound_ms, bound_by = bound(ops, 'f32', nbytes)
    print(f'[12 backward vs plain] b{BATCH} bf16, ring rig: kernel {ms:.4f} '
          f'/ {ms_again:.4f} ms before / after the old design '
          f'({bound_ms / ms:.3f} of its {bound_ms:.4f} ms {bound_by} bound: '
          f'{ops / 1e9:.3f} GFLOP f32, {nbytes / 1e9:.4f} GB); its steps: '
          f'histogram zero + count {steps[0]:.4f}, torch.cumsum '
          f'{steps[1]:.4f}, fill + gather {steps[2]:.4f} ms; the old design '
          f'(f32 atomics) memset {old[0]:.4f}, kernel {old[1]:.4f}, '
          f'casts {old[2]:.4f} = {old.sum():.4f} ms; plain PyTorch '
          f'(index_add_) {plain_ms:.4f} ms; by CUDA events ({card})')
    return worst, ms, plain_ms, bound_ms, bound_by


def _small_sorted_config():
    import dataclasses

    cfg = _small_config()
    return dataclasses.replace(cfg, pillars=dataclasses.replace(
        cfg.pillars, pillar_impl='sorted', max_voxels=256,
        max_points_per_voxel=8))


def phase_sorted_serving(dev):
    """A sorted-pillar Predictor, f32 on the GPU against the CPU, one b4
    request at small size."""
    import torch

    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    cfg = _small_sorted_config()
    sd = random_state_dict(cfg, seed=2)
    req = random_request(np.random.RandomState(5), cfg, batch=BATCH,
                         n_points=600)
    gpu = Predictor(cfg, sd, device=dev, dtype=torch.float32)
    cpu = Predictor(cfg, sd, device='cpu', dtype=torch.float32)
    out_g = {k: v.cpu() for k, v in gpu.forward(*req).items()}
    out_c = cpu.forward(*req)
    worst = 0.0
    for k in ('bev', 'cls_score', 'bbox_pred', 'dir_pred', 'depth'):
        rel = float((out_g[k] - out_c[k]).abs().max() / out_c[k].abs().max())
        check(rel <= 1e-4, f'sorted GPU vs CPU {k}: {rel:.3e} of max|ref|')
        worst = max(worst, rel)
    dec_g = [t.cpu() for t in gpu(*req)]
    dec_c = cpu(*req)
    check(torch.equal(dec_g[3].sum(-1), dec_c[3].sum(-1))
          and int(dec_c[3].sum()) > 0, 'sorted GPU and CPU keep different '
          'numbers of boxes')
    row_err = max(kept_row_distance(dec_g, dec_c, s) for s in range(BATCH))
    check(row_err <= 1e-4, f'sorted GPU and CPU kept rows differ by '
          f'{row_err}')
    print(f'[13 sorted pillars served] b{BATCH} small-size request, GPU f32 '
          f'vs CPU f32: network outputs within {worst:.3e} of max|ref|; '
          f'{int(dec_c[3].sum())} kept rows within {row_err:.1e}')


def _train_state(cfg, state_dict, dev, lr):
    import torch

    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.train.loop import create_train_state
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    model = BEVFusion(cfg)
    model.load_state_dict(state_dict)
    model.to(dev, memory_format=torch.channels_last)
    return create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(lr, 1000, warmup_iters=0)))


def small_train_case(seed):
    """(config, state_dict, batch) of the small GPU-vs-CPU train step:
    sorted pillars, no frozen backbone BN, every BatchNorm bias at +4."""
    import dataclasses

    from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                         random_train_batch)

    cfg = dataclasses.replace(_small_sorted_config(),
                              frozen_backbone_bn=False)
    sd = random_state_dict(cfg, seed)
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'bias'] += 4.0
    batch = random_train_batch(np.random.RandomState(seed), cfg, 2,
                               n_points=600, max_gt=8)
    batch['gt_boxes'][..., :2] /= 5          # inside the small grid
    return cfg, sd, batch


def phase_small_train(dev):
    """One small f32 train step on the GPU against the CPU (TF32 off)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import make_train_step

    cfg, sd, batch = small_train_case(seed=3)
    lr = 1e-3
    runs = []
    for device in ('cpu', dev):
        state = _train_state(cfg, sd, device, lr)
        grads = {}
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
                 for k, p in state.model.named_parameters()]
        loss_fn = make_loss_fn_generic(state.model, 'bevfusion',
                                       cfg.pillars.anchors(),
                                       camera_depth_range=(1.0, 9.0, 1.0))
        before = lss_sample_bev_backward.launches
        _, loss, _ = make_train_step(loss_fn)(state, batch)
        for h in hooks:
            h.remove()
        runs.append((float(loss), lss_sample_bev_backward.launches - before,
                     {k: v.cpu() for k, v in grads.items()},
                     {k: v.cpu() for k, v in state.model.state_dict().items()
                      if v.is_floating_point()}))
    (l_c, n_c, g_c, s_c), (l_g, n_g, g_g, s_g) = runs
    check(n_c == 0 and n_g == 1, f'backward kernel launches CPU {n_c}, GPU '
          f'{n_g}')
    rel_loss = abs(l_g - l_c) / abs(l_c)
    diff = sum(float((g_g[k] - g).square().sum()) for k, g in g_c.items())
    norm = sum(float(g.square().sum()) for g in g_c.values())
    rel_grad = (diff / norm) ** 0.5
    stat_err = max(float((s_g[k] - v).abs().max() / v.abs().max())
                   for k, v in s_c.items() if 'running' in k)
    param_err = max(float((s_g[k] - v).abs().max()) for k, v in s_c.items()
                    if 'running' not in k)
    print(f'[14 small train step] GPU f32 vs CPU f32: loss {l_g:.6f} vs '
          f'{l_c:.6f} ({rel_loss:.2e}), gradient {rel_grad:.2e} in relative '
          f'L2, BatchNorm statistics {stat_err:.2e} of max, parameters '
          f'after AdamW within {param_err / lr:.3f} learning rates')
    check(rel_loss <= 1e-5 and rel_grad <= 1e-4 and stat_err <= 1e-4
          and param_err <= 2.5 * lr, 'GPU train step off the CPU one')


def phase_train(dev, card, batch, state_dict, cfg=None, mtype='bevfusion',
                label='15 train step', falling=False):
    """Full-width training under the bf16 policy at ``batch`` (the fusion
    model of ``configs/bevfusion.py``, or ``cfg`` of family ``mtype``):
    1 warm-up and N_TIMED timed steps.  Returns (ms per step, (LSS
    backward launches, the LSS forward's))."""
    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample, lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import batch_to, make_train_step

    cfg = cfg or BEVFusionConfig()
    rng = np.random.RandomState(100 + batch)
    t0 = time.perf_counter()
    batches = []
    for _ in range(1 + N_TIMED):
        b = random_train_batch(rng, cfg, batch)
        if not cfg.radar_stream:
            del b['points'], b['points_mask']
        batches.append(batch_to(b, dev))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    state = _train_state(cfg, state_dict, dev, lr=2e-4)
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        state.model, mtype, cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range)))
    depth_conv = state.model.lss.depthnet.depth_conv.weight
    seen = []
    hook = depth_conv.register_hook(lambda g: seen.append(g.abs().amax()))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev_ms, losses, counts = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    lss_sample_bev.launches = lss_sample_bev_backward.launches = 0
    lss_sample.launches = 0
    for b in batches:
        start.record()
        state, loss, aux = step(state, b)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        counts.append((lss_sample_bev.launches,
                       lss_sample_bev_backward.launches))
    launches = (lss_sample_bev_backward.launches, lss_sample_bev.launches)
    hook.remove()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = len(batches)
    check(counts == [(k, k) for k in range(1, steps + 1)],
          f'(LSS forward, backward) launches after each step {counts}, not '
          f'one each per step')
    check(lss_sample.launches == 0, 'training launched the fields-in entry')
    check(all(np.isfinite(losses)), f'non-finite losses {losses}')
    check(not falling or losses[-1] < losses[0],
          f'losses do not fall: {losses}')
    check(all(float(v) > 0 for v in seen) and len(seen) == steps,
          'DepthNet depth_conv got no gradient')
    ms = float(np.mean(dev_ms[1:]))
    print(f'[{label}] b{batch}, bf16 policy, {N_TIMED} steps (+1 '
          f'warm-up): {ms:.2f} ms/step by CUDA events ({dev_ms[1:]}), '
          f'{batch * 1e3 / ms:.3f} samples/s, peak {peak:.2f} GiB allocated '
          f'({card}); losses {[round(v, 4) for v in losses]}, grad norm '
          f'{float(aux["grad_norm"]):.3f}, depth_conv max|grad| '
          f'{float(seen[-1]):.3e}; (LSS forward, backward) launches after '
          f'each step {counts}; {steps} batches made and uploaded in '
          f'{data_s:.1f} s')
    del state, step, batches
    torch.cuda.empty_cache()
    return ms, launches


PILLAR_CONFIGS = ('configs/pointpillars_radar.py', 'configs/radarpillarnet.py',
                  'configs/pointpillars_lidar.py')
PILLAR_BATCH = 8                       # samples_per_device of the configs
PILLAR_POINTS = {'radar': 40000, 'lidar': 120000}
PILLAR_GT = 64
SMALL_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 5.0)


def pillar_batch(rng, model, batch, n_points, max_gt=PILLAR_GT,
                 train=True):
    """A synthetic batch for a pillar model: ``n_points`` points per
    sample uniform over its range (all valid; xyz, then the other
    ``point_dims - 3`` dims uniform over +-3), and ``max_gt`` GT boxes
    inside it (centres uniform, sizes 1-4 m, yaw uniform, labels over the
    classes)."""
    cfg = model.cfg
    x0, y0, z0, x1, y1, z1 = cfg.point_cloud_range
    dims = model.point_dims
    pts = rng.uniform(-3, 3, (batch, n_points, dims)).astype(np.float32)
    pts[..., 0] = rng.uniform(x0 + 0.5, x1 - 0.5, (batch, n_points))
    pts[..., 1] = rng.uniform(y0 + 0.5, y1 - 0.5, (batch, n_points))
    pts[..., 2] = rng.uniform(z0 + 1, z1 - 1, (batch, n_points))
    out = {'points': pts, 'points_mask': np.ones((batch, n_points), bool)}
    if train:
        boxes = rng.uniform(-1, 1, (batch, max_gt, 9)).astype(np.float32)
        boxes[..., 0] = rng.uniform(0.9 * x0, 0.9 * x1, (batch, max_gt))
        boxes[..., 1] = rng.uniform(0.9 * y0, 0.9 * y1, (batch, max_gt))
        boxes[..., 3:6] = rng.uniform(1, 4, (batch, max_gt, 3))
        boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch, max_gt))
        out.update(gt_boxes=boxes, gt_labels=rng.randint(
            0, cfg.num_classes, (batch, max_gt)).astype(np.int32),
            gt_mask=np.ones((batch, max_gt), bool))
    return out


def _small_pillar_cases():
    """name -> (PointPillarsConfig, point dims) at a small size: 16x16
    pillars of 1 m, SECOND 64/128/256, FPN 3x128."""
    import dataclasses

    from omnihd_scenes_tpu_torch.config import PointPillarsConfig

    base = PointPillarsConfig(
        point_cloud_range=SMALL_RANGE, voxel_size=(1.0, 1.0, 8.0),
        max_voxels=200, max_points_per_voxel=8, bev_hw=(16, 16),
        anchor_ranges=tuple((-8.0, -8.0, z, 8.0, 8.0, z)
                            for z in (0.91, 1.142, 0.906, 1.516)))
    return {
        'radar sorted': (base, 8),
        'radar dense': (dataclasses.replace(base, pillar_impl='dense'), 8),
        'RadarPillarNet': (dataclasses.replace(
            base, with_velocity_snr_center=True), 8),
        'LiDAR 4 dims, 64 per pillar': (dataclasses.replace(
            base, max_points_per_voxel=64), 4)}


def phase_pillars_small(dev):
    """PointPillars radar (sorted and dense), RadarPillarNet and LiDAR at
    a small size, f32 on the GPU against the CPU (TF32 off): eval-mode
    head maps within 1e-4 of max|ref| and the same kept rows after decode
    + NMS of the same maps (weights as drawn), one train step's loss
    within 1e-5 and gradient within 1e-4 (relative L2; BatchNorm biases
    +4)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)
    from omnihd_scenes_tpu_torch.models.detectors import PointPillars
    from omnihd_scenes_tpu_torch.train.builder import (init_model,
                                                       make_loss_fn_generic)
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    before = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    for name, (cfg, dims) in _small_pillar_cases().items():
        model = init_model(PointPillars(cfg, dims),
                           torch.Generator().manual_seed(4))
        # Weights as drawn for the forward and the decode (a saturated
        # head would tie scores, which top-k orders by device); BatchNorm
        # biases +4 for the train step.
        sd_raw = model.state_dict()
        sd = {k: v.clone() for k, v in sd_raw.items()}
        for k in [k for k in sd if k.endswith('.running_mean')]:
            sd[k[:-len('running_mean')] + 'bias'] += 4.0
        rng = np.random.RandomState(6)
        batch = pillar_batch(rng, model, 2, 600, max_gt=8)
        batch['gt_boxes'][..., :2] *= 0.8
        anchors = cfg.anchors()
        runs = []
        for device in ('cpu', dev):
            m = PointPillars(cfg, dims)
            m.load_state_dict(sd_raw)
            m.to(device)
            with torch.no_grad():
                out = {k: v.cpu() for k, v in m.eval()(
                    torch.from_numpy(batch['points']).to(device),
                    torch.from_numpy(batch['points_mask']).to(device)
                ).items()}
            m.load_state_dict(sd)
            if device == 'cpu':
                maps = {k: out[k] for k in ('cls_score', 'bbox_pred',
                                            'dir_pred')}
            # Decode + NMS of the CPU's head maps on each device (phase
            # 4's rule: near-ties of the maps may flip a kept box).
            dets = [t.cpu() for t in anchor_head_get_bboxes(
                *(maps[k].to(device) for k in ('cls_score', 'bbox_pred',
                                               'dir_pred')),
                torch.from_numpy(anchors).to(device))]
            state = create_train_state(m, lambda p: make_optimizer(
                p, make_lr_schedule(1e-3, 100, warmup_iters=0)))
            grads = {}
            hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
                     for k, p in m.named_parameters()]
            _, loss, _ = make_train_step(make_loss_fn_generic(
                m, 'pointpillars', anchors))(state, batch)
            for h in hooks:
                h.remove()
            runs.append((out, dets, float(loss),
                         {k: v.cpu() for k, v in grads.items()}))
        (o_c, d_c, l_c, g_c), (o_g, d_g, l_g, g_g) = runs
        worst = max(float((o_g[k] - o_c[k]).abs().max() / o_c[k].abs().max())
                    for k in ('cls_score', 'bbox_pred', 'dir_pred', 'bev'))
        kept = [int(d[3].sum()) for d in (d_c, d_g)]
        row = max(kept_row_distance(d_g, d_c, s) for s in range(2))
        rel_loss = abs(l_g - l_c) / abs(l_c)
        rel_grad = (sum(float((g_g[k] - g).square().sum())
                        for k, g in g_c.items())
                    / sum(float(g.square().sum())
                          for g in g_c.values())) ** 0.5
        print(f'[16 pillars small] {name}: GPU vs CPU f32 maps within '
              f'{worst:.2e} of max|ref|; kept rows {kept}, within {row:.1e}; '
              f'train step loss {l_g:.5f} vs {l_c:.5f} ({rel_loss:.1e}), '
              f'gradient {rel_grad:.1e} relative L2')
        check(worst <= 1e-4, f'{name}: maps off by {worst}')
        check(kept[0] == kept[1] and kept[0] > 0 and row <= 1e-4,
              f'{name}: kept rows differ ({kept}, {row})')
        check(rel_loss <= 1e-5 and rel_grad <= 1e-4,
              f'{name}: train step off ({rel_loss}, {rel_grad})')
    check((lss_sample_bev.launches, lss_sample_bev_backward.launches)
          == before, 'a pillar model launched an LSS kernel')


def phase_pillars_full(dev, card, path):
    """A shipped pillar configuration at full width (320x480 at 0.25 m,
    30,000 pillars, SECOND 64/128/256, FPN 3x128, 307,200 anchors) with
    seeded random weights: one warm-up and one timed b8 eval-mode forward
    + decode + NMS, then 1 warm-up and N_TIMED timed f32 train steps at b8
    (the CLI's default precision; the config's lr without its warm-up) on
    fresh synthetic batches."""
    import torch

    from omnihd_scenes_tpu_torch.train.builder import (
        anchors_for, build_model_from_cfg, init_model, make_loss_fn_generic,
        make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.loop import (batch_to,
                                                    create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    cfg = Config.fromfile(path)
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0)).to(dev)
    kind = cfg.data.train.modality
    n_points = PILLAR_POINTS[kind]
    anchors = anchors_for(model, mtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    predict = make_predict_fn_generic(model, mtype, anchors)
    req = batch_to(pillar_batch(np.random.RandomState(8), model,
                                PILLAR_BATCH, n_points, train=False), dev)
    predict(model, req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start.record()
    boxes, scores, labels, valid = predict(model, req)
    end.record()
    torch.cuda.synchronize()
    infer_ms = start.elapsed_time(end)
    infer_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    finite = bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
    check(boxes.shape == (PILLAR_BATCH, 500, 9) and finite,
          f'{path}: decode {tuple(boxes.shape)}, finite {finite}')
    del req

    rng = np.random.RandomState(7)
    batches = [batch_to(pillar_batch(rng, model, PILLAR_BATCH, n_points), dev)
               for _ in range(1 + N_TIMED)]
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(cfg.optimizer.lr, 1000, warmup_iters=0)))
    step = make_train_step(make_loss_fn_generic(model, mtype, anchors))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dev_ms, losses = [], []
    for b in batches:
        start.record()
        state, loss, aux = step(state, b)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms = float(np.mean(dev_ms[1:]))
    print(f'[17 pillars full width] {path} ({mtype}, {kind}, '
          f'{model.point_dims} dims, {n_points} points, '
          f'{model.cfg.max_points_per_voxel} per pillar): b{PILLAR_BATCH} '
          f'inference (forward + decode + NMS) {infer_ms:.2f} ms, peak '
          f'{infer_peak:.2f} GiB, {int(valid.sum())} boxes kept; '
          f'b{PILLAR_BATCH} f32 train {ms:.2f} ms/step by CUDA events '
          f'({dev_ms[1:]}), {PILLAR_BATCH * 1e3 / ms:.2f} samples/s, peak '
          f'{peak:.2f} GiB; losses {[round(v, 3) for v in losses]}, grad '
          f'norm {float(aux["grad_norm"]):.3f} ({card})')
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f'{path}: losses {losses}')
    del state, step, model, batches
    torch.cuda.empty_cache()


def phase_lss_camera(dev, card):
    """The LSS camera-only model of ``configs/lss_camera.py`` at full
    width: b4 bf16-policy train steps (one LSS forward and one backward
    launch each, finite and falling losses) and one b4 bf16 request."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample, lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)
    from omnihd_scenes_tpu_torch.train.config import Config

    model, mtype = build_model_from_cfg(Config.fromfile(
        'configs/lss_camera.py'))
    cfg = model.cfg
    sd = init_model(model, torch.Generator().manual_seed(0)).state_dict()
    del model
    _, (back, fwd) = phase_train(
        dev, card, BATCH, sd, cfg=cfg, mtype=mtype,
        label='18 LSS camera-only train step', falling=True)
    predictor = Predictor(cfg, sd, device=dev, dtype=torch.bfloat16)
    _, _, imgs, rots, trans = random_request(np.random.RandomState(9), cfg,
                                             BATCH, n_points=1)
    predictor(None, None, imgs, rots, trans)
    torch.cuda.synchronize()
    lss_sample_bev.launches = lss_sample.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    boxes, scores, labels, valid = predictor(None, None, imgs, rots, trans)
    end.record()
    torch.cuda.synchronize()
    infer = lss_sample_bev.launches
    check(infer == 1 and lss_sample.launches == 0,
          f'LSS camera-only request launched the fused kernel {infer} times')
    check(boxes.shape == (BATCH, 500, 9)
          and bool(torch.isfinite(boxes).all()), 'camera-only decode')
    print(f'[18 LSS camera-only request] b{BATCH} bf16 (ResNet50, FPNC, '
          f'DepthNet, LSS 16x160x240, head on the 256-channel camera BEV): '
          f'{start.elapsed_time(end):.2f} ms by CUDA events, one '
          f'lss_sample_bev launch, {int(valid.sum())} boxes kept ({card})')
    del predictor
    torch.cuda.empty_cache()
    return {'train_fwd': fwd, 'train_back': back, 'infer': infer}


def phase_cli(dev, card):
    """The CLIs on the card: a synthetic dataroot without images, its
    infos, ``tools.train`` on ``configs/synthetic/pointpillars_radar_synth.py``
    and ``tools.test --eval`` as subprocesses (finite mAP and NOS in the
    metrics JSON), then the micro-train recipe of
    ``tests/test_learning_quick.py`` on the card (mAP > 0.5, NOS > 0.45)."""
    import os
    import subprocess
    import sys
    import tempfile

    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)

    config = 'configs/synthetic/pointpillars_radar_synth.py'
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'synth')
        generate(root, 'v1.0-mini', SyntheticConfig(), images=False)
        create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                               max_sweeps=0)
        opts = ['--cfg-options', f'dataroot={root}',
                f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
                f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']
        work = os.path.join(tmp, 'work')
        times = []
        for args in (['omnihd_scenes_tpu_torch.tools.train', config,
                      '--work-dir', work],
                     ['omnihd_scenes_tpu_torch.tools.test', config,
                      os.path.join(work, 'ckpts'), '--eval', '--out-dir',
                      os.path.join(work, 'test')]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, '-m', *args, *opts],
                                  capture_output=True, text=True,
                                  timeout=600)
            times.append(time.perf_counter() - t0)
            check(proc.returncode == 0, f'{args[0]} exited '
                  f'{proc.returncode}: {proc.stderr[-2000:]}')
        with open(os.path.join(work, 'test', 'metrics.json')) as f:
            metrics = json.load(f)
        with open(os.path.join(work, 'train.log.json')) as f:
            env = json.loads(f.readline())
        check(np.isfinite(metrics['mAP']) and np.isfinite(metrics['NOS']),
              f'CLI metrics {metrics}')
        check(env['device'].startswith('cuda'), f'tools.train ran on {env}')
        print(f'[19 CLIs] tools.train ({env["device_name"]}) '
              f'{times[0]:.1f} s and tools.test --eval {times[1]:.1f} s '
              f'(whole processes): mAP {metrics["mAP"]:.4f}, NOS '
              f'{metrics["NOS"]:.4f}')
        t0 = time.perf_counter()
        metrics, losses = micro_train(root, os.path.join(tmp, 'micro'), dev)
        seconds = time.perf_counter() - t0
    print(f'[19 micro-train] 350 epochs of the quick recipe on the card in '
          f'{seconds:.1f} s ({card}): loss {losses[0]:.3f} -> '
          f'{losses[-1]:.3f}, mAP {metrics["mAP"]:.4f}, NOS '
          f'{metrics["NOS"]:.4f}')
    check(metrics['mAP'] > 0.5 and metrics['NOS'] > 0.45,
          f'micro-train missed the bound: {metrics}')


MICRO_RANGE = (-40.0, -30.0, -3.0, 40.0, 30.0, 5.0)


def micro_train(dataroot, work_dir, device, epochs=350):
    """The micro-train recipe of ``tests/test_learning_quick.py`` on the
    port: a PointPillars with 1 m pillars over the cropped +-40 x +-30 m
    range (60x80 grid, channels 16/32/32) trained on the synthetic train
    split (8 samples, batch 8) for ``epochs`` epochs at lr 1e-2 (20
    warm-up steps), then decoded (128 candidates, 32 boxes) and scored by
    the devkit eval on the same split.  Returns (metrics, losses of the
    last step of each epoch)."""
    import torch

    from omnihd_scenes_tpu_torch.config import DecodeCfg, PointPillarsConfig
    from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.models.detectors import PointPillars
    from omnihd_scenes_tpu_torch.train.builder import init_model
    from omnihd_scenes_tpu_torch.train.detection import (make_loss_fn,
                                                         make_predict_fn,
                                                         run_inference)
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    infos = f'{work_dir}/infos'
    create_newscenes_infos(dataroot, infos, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    ann = f'{infos}/synth_infos_temporal_train.pkl'
    common = dict(ann_file=ann, modality='radar', max_points=2000, max_gt=24,
                  pc_range=list(MICRO_RANGE))
    train_ds = NewScenesDetDataset(point_shuffle=True, **common)
    eval_ds = NewScenesDetDataset(test_mode=True, **common)
    model = PointPillars(PointPillarsConfig(
        point_cloud_range=MICRO_RANGE, voxel_size=(1.0, 1.0, 8.0),
        max_voxels=1024, max_points_per_voxel=8, bev_hw=(60, 80),
        pfn_channels=(16,), second_channels=(16, 32, 32),
        fpn_channels=(16, 16, 16)), train_ds.point_dim)
    init_model(model, torch.Generator().manual_seed(0)).to(device)
    loader = TrainLoader(train_ds, 8, seed=0)
    schedule = make_lr_schedule(1e-2, len(loader) * epochs, warmup_iters=20)
    state = create_train_state(model,
                               lambda p: make_optimizer(p, schedule))
    step = make_train_step(make_loss_fn(model))
    losses = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            state, loss, _ = step(state, batch)
        losses.append(loss)
    losses = [float(v) for v in losses]
    results = run_inference(make_predict_fn(model, DecodeCfg(
        nms_pre=128, max_num=32)), model, eval_ds, 2)
    metrics = eval_ds.evaluate(results, dataroot=dataroot,
                               version='v1.0-mini', eval_set='train_mini',
                               jsonfile_prefix=f'{work_dir}/eval')
    return metrics, np.asarray(losses)


def main():
    card = phase_device()
    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig, serving_config
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
    phase_int8_exact(int8, int8_request)
    torch.backends.cudnn.allow_tf32 = False
    phase_int8_vs_bf16(predictor, int8, int8_request)
    del predictor, int8, int8_request, request
    torch.cuda.empty_cache()
    back_row = phase_backward(dev, card)
    phase_sorted_serving(dev)
    phase_small_train(dev)
    train_sd = random_state_dict(BEVFusionConfig(), seed=0)
    train = {b: phase_train(dev, card, b, train_sd) for b in TRAIN_BATCHES}
    back_launches = train[BATCH][1][0]
    del train_sd
    phase_pillars_small(dev)
    for path in PILLAR_CONFIGS:
        phase_pillars_full(dev, card, path)
    cam = phase_lss_camera(dev, card)
    phase_cli(dev, card)
    # (source, launches, max |d|, ms, plain ms, bound ms, bound_by, library
    # ms): lss_sample is the fused kernel (launches of the bf16 serving
    # path; the int8 one and training launched it once per request or
    # step too) at b4, its backward (launches of the b4 training phase;
    # max |d| over bf16 and f32), its
    # fields-in entry (on no serving path) at b4, qconv at the DepthNet
    # block (library: _int_mm on im2col), bconv at d = 6 (library: cuDNN's
    # bf16 conv).
    rows = {'lss_sample': ('lss_sample', launches, *lss_row, None),
            'lss_sample_backward': ('lss_sample', back_launches, *back_row,
                                    None),
            'lss_sample_fields_in': ('lss_sample', fields_launches,
                                     *fields_row, None),
            'qconv': ('qconv', q_launches, *q_row),
            'bconv': ('bconv', b_launches, *b_row)}
    # Launches on the LSS camera-only path (phase 18): its b4 training
    # run (1 + N_TIMED steps) and one b4 request.
    lss_camera = {'lss_sample': {'train_b4': cam['train_fwd'],
                                 'request_b4': cam['infer']},
                  'lss_sample_backward': {'train_b4': cam['train_back']}}
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'{CSRC}{src}.cu',
        'replaces': KERNEL_REPLACES[name][0],
        **({'also_replaces': KERNEL_REPLACES[name][1]}
           if len(KERNEL_REPLACES[name]) > 1 else {}),
        'launches': n, 'max_abs_err': e, 'ms': t, 'plain_ms': pt,
        'bound_ms': bt, 'bound_by': by, 'library_ms': lib,
        **({'launches_lss_camera': lss_camera[name]}
           if name in lss_camera else {})}
        for name, (src, n, e, t, pt, bt, by, lib) in rows.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
