#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA device, ``nvcc`` and
``nvidia-smi``, and imports no JAX.  Phases, one line each (or more):

1. device: torch/CUDA versions, the card's name and power limit; TF32
   off for the parity phases;
2. build: the kernels (``kernels/csrc/lss_sample.cu``, ``qconv.cu``,
   ``bconv.cu``, ``rectify.cu``, ``jpeg_idct.cu``, ``photometric.cu``,
   ``crop_resize_flip.cu``) and the nvJPEG binding
   (``nvjpeg.cpp``: the encoder, and the decode yardstick)
   from source for sm_90a, one ``nvcc`` each, all started together; build
   seconds, registers and spills;
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
   mAP > 0.5 and NOS > 0.45, with its seconds;
20. BEVFusion-OCC (``MTLConfig``) at a small size (16x16 BEV at 1 m,
   sorted pillars, 12 classes over 4 z bins), f32 on the GPU against the
   CPU, TF32 off, for each ``trunk_mode`` ('none', 'per_task' behind
   non-identity detection and occupancy grid crops, 'shared'): network
   outputs and occupancy logits within 1e-4 of max|ref| (weights as
   drawn), the occupancy argmax equal wherever the CPU's top two logits
   differ by more than 1e-5 of max|logit| (the number of differing voxels
   printed), one train step's loss within 1e-5 and gradient within 1e-4
   in relative L2 (BatchNorm biases +4), one LSS backward launch;
21. BEVFusion-OCC serving at full width (``bench.py --mtl``'s model: the
   serving configuration inside ``MTLConfig``), b4 bf16, 1 + 3 requests
   of fresh inputs: ms by CUDA events, samples/s, the difference to phase
   5's request, peak GiB, one ``lss_sample_bev`` launch per request, the
   (4, 240, 160, 16) int64 occupancy argmax on the card, in the class
   range and moving with the input;
22. BEVFusion-OCC training at full width (``configs/bevfusion_occ.py``
   built by ``build_model_from_cfg``: sorted pillars, synthetic ``gt_occ``
   of ``serve/synthetic.py``), 1 + 3 b4 bf16-policy steps as phase 15:
   ms, peak GiB, finite losses with the total, ``loss_occ`` and
   ``loss_ssc`` falling, one LSS forward and one backward launch per step;
23. RCFusion: the small GPU-vs-CPU checks of phase 20 (no occupancy), 1 +
   3 b4 bf16 requests of the serving configuration with the cross-modal
   fuser (ms, peak GiB, one LSS launch each), and 1 + 3 b4 bf16-policy
   steps of ``configs/rcfusion.py`` as phase 22.
24. BEVFormer-T R50 streaming inference (``serve/predictor.py:
   StreamPredictor``, seeded random weights with query-dependent
   deformable offsets): (a) ``configs/synthetic/bevformer_synth.py``'s
   model, f32, the GPU against the CPU over a 3-frame stream with a scene
   boundary (the BEV within 1e-4 of max|ref|, decoded rows as multisets);
   (b) ``configs/bevformer_t_r50.py`` at full width (BEV 160x240 x 256,
   900 queries, 3 + 6 layers, 6 cameras at 544x960, R50 + one-level
   FPN), one bf16 stream, 1 warm-up + 6 timed frames of fresh images with
   the previous BEV carried on the card: ms per frame by CUDA events,
   samples/s, peak GiB; the stage split by CUDA events on one more frame
   (upload, backbone, FPN, encoder with its TSA / SCA / FFN, decoder,
   branches, decode); multi-scale deformable attention (plain PyTorch,
   ``F.grid_sample``) per call and per frame (3 TSA + 3 x 6 SCA + 6
   decoder calls), each of its three shapes timed alone beside its byte
   bound and ``F.grid_sample`` alone; the SCA cap: 0 hit queries dropped
   on the ring rig at 0.375, the stream served at 0.375 beside 1.0; bf16
   against an f32 stream on the same weights (BEV error, kept-box match);
   (c) four scene-parallel bf16 streams, 1 + 3 frames, one stream at a
   scene boundary mid-way: ms, samples/s, peak GiB in all and per stream.
25. BEVFormer-T training: (a) one step of the synthetic config's model
   (B=2 queues of 2 frames, 10 of 16 GTs) on the CPU in f64, then in f32
   on the CPU and twice on the card, TF32 off, each f32 step taking the
   f64 step's side at every ReLU and max-pool: the card's matches of
   every decoder layer equal to the CPU's, its loss within 1e-5, each
   gradient leaf within GRAD_SHARE of its max|CPU f32|, the two card runs
   equal in matches and losses; printed beside it, the sides the CPU's
   f32 step takes on its own and their cost against the f64 step; (b)
   ``configs/bevformer_t_r50.py`` at full width under the bf16 policy
   with AdamW + clip 35, B=1, 1 warm-up and 3 timed steps of fresh
   ``random_queue_batch`` queues (40 of 128 GTs): ms per step by CUDA
   events, samples/s, peak GiB, finite losses and parameters; the
   split of one more step (history replay, last-frame forward, matching
   with its host ms, loss, backward, optimizer); the host syncs of one
   more step under ``torch.cuda.set_sync_debug_mode('warn')``: exactly
   one, the matcher's copy of the costs;
26. R101-DCN: (a) the synthetic model with DCNv2 on stages 3-4 and
   offset-conv biases over +-2 pixels (taps leave the maps), f32: one
   frame's BEV on the card within 1e-4 of max|CPU|, and one train step
   held as in 25a; (b) ``configs/bevformer_t_r101.py`` at full width
   (ResNet-101, 26 DCN layers, 6 x 864x1536), one bf16 stream of 1 + 6
   frames: ms per frame, samples/s, peak GiB, a frame under
   ``set_sync_debug_mode('error')``, the stage split with the DCN layers'
   ms, and each DCN layer shape alone beside its bound (JSON); then the
   frames, the split and the shapes again at the init's zero offset
   convs.  No hand kernel lies on either path: phases 25 and 26 check
   that none launched.  26a also holds one DCN layer with zero offset
   convs (every tap on a texel centre): its offset-conv gradient on the
   card equals the CPU port's (both the floor side) within GRAD_SHARE;
27. augmented BEVFusion training at full width: ``configs/bevfusion.py``'s
   model, b4 under the bf16 policy, 1 warm-up + 3 timed steps, each
   sample through the port's ``photometric_distortion`` and
   ``global_rot_scale_trans_image`` with the draws forced over the
   rotation range's two ends and flip_dx / flip_dy on and off (the
   augmented geometry: ``img2lidar`` recomputed in f64); on that geometry
   the fused LSS kernel's dumped (j, i, kd) against the plain fields
   under phase 3's rule, its f32 / bf16 output against the plain gather,
   and the backward against its plain version at phase 12's tolerance;
   then the steps as phase 15 (ms, peak GiB, finite losses, one LSS
   forward and one backward launch per step), and one more step through
   ``train/loop.py:run_training`` (the pinned prefetch on a side stream)
   under ``set_sync_debug_mode('warn')``: exactly one host sync, in the
   logger's read of the step's scalars (``loop.py:_read_scalars``);
28. the host feed and staged weights: on an image-less synthetic dataroot
   the radar pillar config's ``TrainLoader`` inline, with 2 workers and
   with 2 workers + the pinned prefetch: samples/s of each, the host's
   cores, the radar decode ms per sweep native and NumPy over alternating
   timed passes, the library's build outside them (rows within
   1e-6 of a row's largest value), pooled batches bit-equal to inline
   ones without ``aug``; ``tools.train configs/pointpillars_radar.py`` as
   a subprocess with 2 workers and the points' ``rot_scale_flip`` (exit
   0, finite losses); its checkpoint through ``load_pts_from`` into
   ``configs/bevfusion.py``'s model on the card (every loaded tensor
   equal, the count printed) and one b4 bf16-policy step.
29. the scatter splat (``splat_mode='scatter'``, plain ``index_add_``,
   no LSS kernel): small f32 on the card against the CPU (1e-4 of
   max|ref|) with the difference of two card runs printed; the serving
   configuration in scatter mode, b4 bf16, 1 + 3 requests (ms, peak GiB,
   B splats and no LSS launch a request); the b4 view transform alone
   (frustum ids, their share, and ``lss_splat``) beside its byte bound
   and the sampling kernel on the same inputs (printed, not checked),
   two runs' difference; ``configs/bevfusion.py`` in scatter mode, 1 + 3
   b4 bf16-policy steps as phase 15, no LSS launch;
30. ``pillar_impl='dense_fold'`` against ``'dense'`` serving, b4 bf16 on
   the same weights, alternating over 1 + 3 requests: ms of each, the
   pillar canvas and head maps within HEAD_TOL of max|dense|;
31. the s2d stem: 1 + 3 b4 bf16 requests of host-packed images (ms,
   peak), the head maps within HEAD_TOL of the standard stem's on the
   unpacked request; int8 + s2d: calibrate on a packed request (the stem
   keeps act_amax only), 1 + 3 requests, qconv once per eligible layer;
32. remat on ``configs/bevfusion.py``: cold b4 bf16-policy first steps
   plain / remat / plain / remat from the same weights and batch (ms,
   peak; running statistics within the plain runs' rounding, so a
   second update on recomputation fails; LSS forward twice, backward
   once a remat step), b2 f32 gradients of remat within GRAD_SHARE of
   each leaf's max|plain|, then warm remat steps at b4 (with the sync
   check of phase 27) and b8;
33. BEVFusion-OCC in int8 (``bench.py --mtl --int8``): calibrate, 1 + 3
   b4 requests (qconv once per eligible layer, the occupancy argmax on
   the card), phase 11's checks against bf16 and the share of equal
   occupancy voxels printed.  Phase 19 also runs ``tools.test --int8
   --eval`` (exit 0, finite metrics, the calibration line).
34. camera dataroots on the card, with ``cv2`` and ``PIL`` blocked: a
   synthetic dataroot of 8 samples, six 1920x1080 cameras with lens
   distortion, written by ``generate(..., image_device='cuda')`` (NumPy
   boxes, nvJPEG encode), and its infos; (a) the card's decode (host
   entropy decode, the IDCT kernel, rectify's colour step) of the
   committed JPEG fixtures against their ``cv2.imdecode``: max |d| 0;
   (b) on one b4 batch of the dataroot (24 images): the host entropy
   decode's ms on 1 thread and on the default count (the CPU model and
   count printed), the coefficients' pinned upload, the IDCT kernel
   against its plain version on the card (bit-equal; also its SASS
   instructions a block, read by ``cuobjdump``, and the issue floor they
   imply at the card's SM clock) and the fused
   rectify kernel against its plain version (bit-equal), each with its
   ms, byte bound and plain ms, nvJPEG's batched decode of the same 24
   JPEGs (the decode's yardstick: Huffman and another IDCT; no PyTorch
   call computes islow, so the IDCT has no library time) and one
   ``F.grid_sample`` on the chain's own grid (rectify's); rectify's setup
   kernels (the packed map; the footprint and taps tables, both from one
   launch a map and geometry) against their plain versions, timed from a
   cold L2; the main path in this process
   (``run_inference_generic`` of ``configs/bevfusion.py``'s seeded model
   at b4 over the val set: one LSS launch, one batched decode, one IDCT
   and one rectify launch a batch, no nvJPEG decode) and
   one batch's host syncs (only the result copy; with the host NMS only
   the candidate copy); on that batch's candidates the in-graph NMS
   against a greedy pass over the card's own IoU matrix (equal, its
   48-step fixpoint converged) and the host NMS against a greedy pass
   over the vectorised f64 IoU matrix (equal, but where a pair's f64 IoU
   lies within 1e-9 of the threshold);
   (c) ``tools.test --eval`` and (d) ``--host-nms`` of
   ``configs/bevfusion.py`` at b4 as subprocesses on a seeded checkpoint
   (exit 0, finite mAP and NOS, one LSS, IDCT and rectify launch and
   one decode a batch, no nvJPEG decode; ``--host-nms``'s kept boxes
   those of the host NMS over the val set in this process on every
   sample, bit for bit; the samples that
   keep the in-graph run's boxes printed); (e)
   ``tools.benchmark`` (24 samples: samples/s and ms a sample of loading,
   upload, decode + rectify, model); (f) ``tools.test --eval`` of
   ``lss_camera``, ``rcfusion``, ``bevfusion_occ`` and
   ``bevformer_t_r50`` at b1, side by side (finite metrics, their
   launches, no nvJPEG decode).
35. camera training from a JPEG dataroot, with ``cv2`` and ``PIL``
   blocked: a 1080p dataroot of 32 samples (16 train) and a 108x192 one,
   both written with nvJPEG, their infos and their depth GT
   (``tools.gen_depth_gt``); (a) on one decoded b4 val batch (24 x
   544x960) the ``photometric`` kernel against its plain version on four
   sets of rows (every step off; every step with contrast before and
   after the HSV steps, swaps; per-view draws) and ``crop_resize_flip``
   (720x408 crops back to 960x544, without, with and mixed flips), both
   bit-equal, with their ms, byte bounds, plain ms and ``F.interpolate``
   of the crops; (b) ``configs/bevfusion.py`` trained at b4 from the
   dataroot with depth targets and all three image augmentations,
   through ``TrainLoader`` (2 spawn workers), ``run_training``'s prefetch
   (the decode on its side stream) and the bf16-policy step: 8 finite
   steps, the IDCT, ``rectify``, ``photometric``, ``crop_resize_flip``
   and the LSS forward and backward kernels launched once a step (the
   counts zeroed just before, read just after), the step gaps beside
   phase 15's step on ready batches, the main stream's busy share, the
   host entropy decode's ms a batch, and the first batch the step saw
   equal to that batch decoded by every kernel's plain version on the
   card; (c) ``tools.train`` on ``configs/synthetic/bevfusion_synth.py``
   (the three augmentations, its eval: finite mAP and NOS) and on
   ``configs/synthetic/bevformer_synth.py`` (temporal queues) from the
   small JPEG dataroot as subprocesses: exit 0 on ``cuda``, finite
   losses, the decode kernels' launches in the log.
36. conv-BN fusion (``serve/fuse.py``) of the full-width serving model,
   seeded weights with BatchNorm statistics drawn away from (0, 1) as
   JAX's ``_randomize_bn`` draws them, traced and verified on the card:
   the pairs fused and skipped; f32 fused against f32 unfused (head maps
   within F32_FUSE_TOL, TF32 off) and b4 bf16 fused against bf16 unfused
   (HEAD_TOL and BOX_MATCH of phase 6), with the kept-row distances and
   the largest score difference; the two bf16 Predictors' request ms (1 +
   3 fresh b4 requests each, two rounds alternating); the BatchNorm
   launches of one request of each by the profiler (``aten::batch_norm``
   calls and device kernels), which must fall by the number of pairs;
37. export (``serve/export.py``): the fused b4 bf16 model exported on the
   card with the LSS kernel as the registered op ``omnihd::lss_sample_bev``
   into a temporary bundle, loaded in a fresh process that must import no
   ``omnihd_scenes_tpu_torch.models`` module (nor JAX), 1 + 3 fresh b4
   requests there: ``lss_sample_bev`` launched once a request inside the
   program, as many kept boxes as the live ``Predictor`` on the same
   requests and at least EXPORT_BOX_MATCH of them matched (the bit-equal
   requests counted, beside the live Predictor's own run-to-run count:
   the dense pillar sums add with atomics), request ms, export and load
   seconds;
38. QAT: the serving model, b4 under the bf16 policy, 4
   ``make_train_step`` steps in ``qat`` (finite losses, every QConv2d and
   the stem with a finite ``act_amax`` > 0, one LSS forward and one
   backward launch a step), then ``freeze`` and the int8 tier through
   ``Predictor(quant_state=...)`` with TF32 on, as phase 10: 1 + 3 b4
   requests, 36 ``qconv3x3`` launches a request, ms;
39. data-parallel training (``parallel/``) of full-width
   ``configs/bevfusion.py`` under the bf16 policy, global b4, 1 + 3 steps:
   39a one rank over NCCL (an all-reduce probe): no collective inside
   its steps, the first loss bit-equal to the same steps without a group
   and the rest within 39b's bounds of them (the one-process steps do
   not repeat bit for bit on the card: atomic backward kernels; a second
   run's spread is printed beside), ms beside phase 15's b4; 39b DP_RANKS spawned ranks of DP_LOCAL samples
   on cuda:0 over gloo (NCCL refuses two ranks on one card): every rank's
   state bit-equal to rank 0's, losses within DP_LOSS_TOL and parameters
   within DP_PARAM_LR learning rates a step of the one-process b4 run,
   a rank's step ms, its gradient all-reduce ms (gloo through the host)
   and peak GiB, one LSS forward and one backward launch a rank a step;
   39c one rank a GPU over NCCL (up to DP_MAX_GPUS) when the machine has
   several, else ``39c not run: 1 device``; 39d ``tools.train`` under
   ``torchrun --nproc_per_node 1`` on a synthetic radar dataroot.
40. the remaining modules at the shipped widths, TF32 off, each new
   forward under ``torch.cuda.set_sync_debug_mode('error')``: 40a the
   CenterPoint head (``models/centerpoint_head.py``) on b4 fused BEVs of
   ``configs/bevfusion.py`` (384 x 160 x 240), 50 padded GT boxes a
   sample: forward, targets + loss, backward and decode (500) on the
   card, the f32 forward within 1e-4 of max|ref| of the same module on
   the CPU, the decoded boxes the CPU's as multisets, forward / loss /
   decode ms and peak GiB; 40b ``MMBEVFormerLayer`` at
   ``configs/bevformer_t_r50.py``'s widths (256 channels, 8 heads, FFN
   512, 6 cameras of 17 x 30 values, BEV 160 x 240) with a 384-channel
   radar BEV (``configs/bevfusion.py``'s SECOND-FPN output): f32 card
   within 1e-4 of max|ref| of the CPU, bf16 within MM_BF16_TOL of f32, ms
   beside ``BEVFormerLayer``'s; 40c chamfer of two 100k-point clouds: the
   card within 1e-6 relative of the CPU on an 8k-point subset, the same
   bits at two chunk sizes, ms and peak GiB; 40d ``tools/get_flops.py``
   on ``configs/bevfusion.py``: parameters equal to the state_dict's
   parameter numels, the card's FLOPs equal to the CPU's (the LSS kernel
   counted by its formula on both, launched once on the card); 40e
   ``utils/timing.py:device_trace`` around one b4 bf16 ``Predictor``
   request: a non-empty Chrome trace naming the LSS kernel and its
   registered op, one ``lss_sample_bev`` launch.

The line before the last is a JSON object of the kernels (launches on
the main paths: the serving path's for the forward kernels, the b4
training phase's for the LSS backward, and for the LSS kernels also the
camera-only path's (phase 18), BEVFusion-OCC's (phases 21-22) and
RCFusion's (phase 23) and the augmented training's (phase 27,
``launches_aug_train``), the scatter path's (29, ``launches_scatter``,
which must be 0), dense_fold's (30), s2d's and int8 + s2d's (31, qconv
too), the remat training run's (32) and BEVFusion-OCC int8's (33, qconv
too), 0 on BEVFormer-T's training run (phase 25b) and
R101-DCN's stream (26b); the rectify and IDCT kernels' from phase 34's
main path; the augmentation kernels' from phase 35b's training run, and
every kernel's there as ``launches_camera_train``; phases 36-38's
fused request, exported program, QAT training and QAT int8 request;
phase 39's per rank, ``launches_data_parallel``),
error against the plain
version, kernel / plain /
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

import contextlib
import json
import re
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
# rectify's setup kernels (kernels/rectify.py), by kernels-line name: one
# row a table; the footprint and taps tables come from one launch
# (geometry_tables), whose count both rows read.
SETUP_KERNELS = ('rectify_pack_map', 'rectify_footprint', 'rectify_taps')
KERNELS = ('lss_sample', 'qconv', 'bconv', 'rectify', 'jpeg_idct',
           'photometric', 'crop_resize_flip', 'nvjpeg')
SPLAT_PASSES = ('omnihd_scenes_tpu/ops/pallas_splat.py:68',
                'omnihd_scenes_tpu/ops/pallas_splat.py:80')
KERNEL_REPLACES = {
    'lss_sample': SPLAT_PASSES,
    # The splat's backward is the einsum VJP inside the custom_vjp of
    # pallas_splat.py:246-261, not a Pallas kernel.
    'lss_sample_backward': ('omnihd_scenes_tpu/ops/pallas_splat.py:246',),
    'lss_sample_fields_in': SPLAT_PASSES,
    'qconv': ('omnihd_scenes_tpu/ops/qconv.py:48',),
    'bconv': ('omnihd_scenes_tpu/ops/bconv.py:41',),
    # No TPU kernel: the JAX package runs these on the host with OpenCV
    # (load_camera_data's undistort, resizes and normalisation; its
    # cv2.imread).
    # rectify's setup kernels serve the same chain: the packed map and the
    # tile footprints its cv2.remap (:133), the taps its f32 cv2.resize.
    'rectify': ('omnihd_scenes_tpu/data/image_loading.py:139',),
    'rectify_pack_map': ('omnihd_scenes_tpu/data/image_loading.py:133',),
    'rectify_footprint': ('omnihd_scenes_tpu/data/image_loading.py:133',),
    'rectify_taps': ('omnihd_scenes_tpu/data/image_loading.py:139',),
    'jpeg_idct': ('omnihd_scenes_tpu/data/image_loading.py:177',),
    # The training augmentations' pixel work, NumPy and cv2.resize on the
    # JAX package's host (photometric_distortion, crop_resize_flip_images).
    'photometric': ('omnihd_scenes_tpu/data/augmentation.py:55',),
    'crop_resize_flip': ('omnihd_scenes_tpu/data/augmentation.py:193',)}
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
# Phase 36: f32 fused against f32 unfused at full width, TF32 off (each
# conv then adds the folded bias in its own rounding).
F32_FUSE_TOL = 1e-4
# Phase 37: the exported program's kept boxes against the live
# Predictor's on the same requests (both sum pillars with atomics, so a
# near tie may keep another box).
EXPORT_BOX_MATCH = 0.99
# Phase 38: QAT steps, and the int8 tier's qconv launches a request (the
# eligible 3x3 convs of the serving configuration, phase 10).
QAT_STEPS = 4
QCONV_PER_REQUEST = 36
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


def kernel_ms(fn, key, iters, warmup):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``key``, by torch.profiler over ``iters`` calls of ``fn`` (a wrapper's
    host work between launches does not count); fails when the profiler
    records no such launch or no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if key in e.key:
            total += getattr(e, 'device_time_total', 0) or e.cuda_time_total
            count += e.count
    check(total > 0 and count > 0, f'the profiler recorded no device time '
          f'of a kernel named *{key}* ({count} launches)')
    return total / count / 1e3


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
        print(f'[2 build] {_build.source_path(name).name} -> {path.name} in '
              f'{seconds[name]:.2f} s (all {len(KERNELS)} in parallel); '
              + ' | '.join(ptxas))


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
    torch.cuda.reset_peak_memory_stats(dev)
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
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f'[5 serving] b{BATCH} x {N_TIMED} requests (+1 warm-up): '
          f'{ms:.2f} ms/request by CUDA events ({dev_ms[1:]}), host '
          f'{float(np.mean(host_ms[1:])):.2f} ms, {BATCH * 1e3 / ms:.2f} '
          f'samples/s, peak {peak:.2f} GiB allocated ({card}); kept boxes {int(valid.sum())}; model setup '
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


def phase_int8_vs_bf16(bf16, int8, request, label='11 int8 vs bf16'):
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
    print(f'[{label}] full-width b{BATCH}, random weights: head '
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


def _model(cfg):
    """BEVFusion (RCFusion with ``rc_fusion='cross_attention'``), or
    BEVFusion-OCC for an ``MTLConfig``."""
    from omnihd_scenes_tpu_torch.config import MTLConfig
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL

    return BEVFusionMTL(cfg) if isinstance(cfg, MTLConfig) else BEVFusion(cfg)


def _fusion(cfg):
    """The fusion trunk's configuration (an ``MTLConfig``'s ``fusion``)."""
    return getattr(cfg, 'fusion', cfg)


def _train_state(cfg, state_dict, dev, lr):
    import torch

    from omnihd_scenes_tpu_torch.train.loop import create_train_state
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    model = _model(cfg)
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


def _small_step_runs(dev, cfg, sd, batch, mtype, lr=1e-3):
    """One f32 train step of ``cfg``'s model from ``sd`` on the CPU, then
    on the GPU: [(loss, LSS backward launches, gradients, floating
    state after the step)] for each."""
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import make_train_step

    runs = []
    for device in ('cpu', dev):
        state = _train_state(cfg, sd, device, lr)
        grads = {}
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
                 for k, p in state.model.named_parameters()]
        loss_fn = make_loss_fn_generic(
            state.model, mtype, cfg.pillars.anchors(),
            camera_depth_range=_fusion(cfg).lss.camera_depth_range)
        before = lss_sample_bev_backward.launches
        _, loss, _ = make_train_step(loss_fn)(state, batch)
        for h in hooks:
            h.remove()
        runs.append((float(loss), lss_sample_bev_backward.launches - before,
                     {k: v.cpu() for k, v in grads.items()},
                     {k: v.cpu() for k, v in state.model.state_dict().items()
                      if v.is_floating_point()}))
    return runs


def _relative_l2(got, want):
    """||got - want|| / ||want|| over every entry of two tensor dicts."""
    diff = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    return (diff / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def phase_small_train(dev):
    """One small f32 train step on the GPU against the CPU (TF32 off)."""
    cfg, sd, batch = small_train_case(seed=3)
    lr = 1e-3
    (l_c, n_c, g_c, s_c), (l_g, n_g, g_g, s_g) = _small_step_runs(
        dev, cfg, sd, batch, 'bevfusion', lr)
    check(n_c == 0 and n_g == 1, f'backward kernel launches CPU {n_c}, GPU '
          f'{n_g}')
    rel_loss = abs(l_g - l_c) / abs(l_c)
    rel_grad = _relative_l2(g_g, g_c)
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
                label='15 train step', falling=False, augment=None,
                per_step=(1, 1), sync_check=False, timed=N_TIMED):
    """Full-width training under the bf16 policy at ``batch`` (the fusion
    model of ``configs/bevfusion.py``, or ``cfg`` of family ``mtype``):
    1 warm-up and ``timed`` timed steps, each launching the LSS forward
    and backward kernels ``per_step`` times; with ``falling``, the total
    loss and the occupancy losses (BEVFusion-OCC) must fall from the first
    step to the last.  ``augment(numpy batch) -> numpy batch`` augments
    each batch; then (or with ``sync_check``) one more step runs through
    ``run_training`` under ``set_sync_debug_mode('warn')`` and its host
    syncs are counted.  Returns (ms per step, (LSS backward launches, the
    LSS forward's))."""
    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample, lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import batch_to, make_train_step

    cfg = cfg or BEVFusionConfig()
    fcfg = _fusion(cfg)
    rng = np.random.RandomState(100 + batch)
    t0 = time.perf_counter()
    batches = []
    sync_check = sync_check or augment is not None
    for _ in range(1 + timed + sync_check):
        b = random_train_batch(rng, cfg, batch)
        if not fcfg.radar_stream:
            del b['points'], b['points_mask']
        if augment is not None:
            b = augment(b)
        batches.append(b)
    host_batch = batches.pop() if sync_check else None
    batches = [batch_to(b, dev) for b in batches]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    state = _train_state(cfg, state_dict, dev, lr=2e-4)
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        state.model, mtype, cfg.pillars.anchors(),
        camera_depth_range=fcfg.lss.camera_depth_range)))
    trunk = getattr(state.model, 'fusion', state.model)
    depth_conv = trunk.lss.depthnet.depth_conv.weight
    seen = []
    hook = depth_conv.register_hook(lambda g: seen.append(g.abs().amax()))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev_ms, losses, counts, occ_losses = [], [], [], []
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
        occ_losses.append({k: float(aux[k]) for k in ('loss_occ', 'loss_ssc')
                           if k in aux})
        counts.append((lss_sample_bev.launches,
                       lss_sample_bev_backward.launches))
    launches = (lss_sample_bev_backward.launches, lss_sample_bev.launches)
    hook.remove()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = len(batches)
    check(counts == [(k * per_step[0], k * per_step[1])
                     for k in range(1, steps + 1)],
          f'(LSS forward, backward) launches after each step {counts}, not '
          f'{per_step} per step')
    check(lss_sample.launches == 0, 'training launched the fields-in entry')
    check(all(np.isfinite(losses)), f'non-finite losses {losses}')
    check(not falling or losses[-1] < losses[0],
          f'losses do not fall: {losses}')
    for k in occ_losses[0]:
        parts = [o[k] for o in occ_losses]
        check(all(np.isfinite(parts)) and (not falling or parts[-1]
                                           < parts[0]),
              f'{k} not finite and falling: {parts}')
    check(all(float(v) > 0 for v in seen) and len(seen) == steps,
          'DepthNet depth_conv got no gradient')
    ms = float(np.mean(dev_ms[1:]))
    print(f'[{label}] b{batch}, bf16 policy, {timed} steps (+1 '
          f'warm-up): {ms:.2f} ms/step by CUDA events ({dev_ms[1:]}), '
          f'{batch * 1e3 / ms:.3f} samples/s, peak {peak:.2f} GiB allocated '
          f'({card}); losses {[round(v, 4) for v in losses]}, grad norm '
          f'{float(aux["grad_norm"]):.3f}, depth_conv max|grad| '
          f'{float(seen[-1]):.3e}; (LSS forward, backward) launches after '
          f'each step {counts}; {steps} batches made and uploaded in '
          f'{data_s:.1f} s')
    if occ_losses[0]:
        rounded = [{k: round(v, 4) for k, v in o.items()} for o in occ_losses]
        print(f'[{label}] occupancy losses per step {rounded}')
    if host_batch is not None:
        syncs, logger = _run_training_syncs(state, step, host_batch)
        print(f'[{label}] one more step through run_training (pinned '
              f'prefetch on a side stream, log_interval 1) under '
              f'set_sync_debug_mode(\'warn\'): {len(syncs)} host sync(s)'
              + ''.join(f'\n[{label}]   sync at {f}:{n}' for f, n in syncs)
              + f' (expected 1: the logger\'s copy in '
              f'{logger.__module__}.{logger.__name__})')
        check(len(syncs) == 1, f'{len(syncs)} host syncs in a run_training '
              f'step: {syncs}')
        check(_in_function(syncs[0], logger),
              f'the run_training step synced at {syncs[0]}, not in {logger}')
    del state, step, batches
    torch.cuda.empty_cache()
    return ms, launches


def _run_training_syncs(state, step, host_batch):
    """One step of ``run_training`` on a host (NumPy) batch under
    ``set_sync_debug_mode('warn')`` -> ([(file, line) of each host sync],
    the logger's one-copy read of the step's scalars, where the single
    expected sync lies)."""
    import warnings

    import torch

    from omnihd_scenes_tpu_torch.train.loop import _read_scalars, run_training

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            run_training(state, step, [host_batch], 1, log_interval=1)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
    return [(w.filename, w.lineno) for w in caught
            if 'called a synchronizing CUDA operation' in str(w.message)
            ], _read_scalars


def _in_function(where, fn):
    """Whether ``where`` = (file, line) lies in ``fn``'s source lines."""
    import inspect
    import os

    lines, first = inspect.getsourcelines(fn)
    return (os.path.samefile(where[0], inspect.getsourcefile(fn))
            and first <= where[1] < first + len(lines))


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
    (boxes, scores, labels, valid), _ = predict(model, req)
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
        times, outs = [], []
        test = ['omnihd_scenes_tpu_torch.tools.test', config,
                os.path.join(work, 'ckpts'), '--eval', '--out-dir']
        for args in (['omnihd_scenes_tpu_torch.tools.train', config,
                      '--work-dir', work],
                     test + [os.path.join(work, 'test')],
                     test + [os.path.join(work, 'int8'), '--int8']):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, '-m', *args, *opts],
                                  capture_output=True, text=True,
                                  timeout=600)
            times.append(time.perf_counter() - t0)
            outs.append(proc.stdout)
            check(proc.returncode == 0, f'{args[0]} exited '
                  f'{proc.returncode}: {proc.stderr[-2000:]}')
        metrics, int8 = ({}, {})
        for name, m in (('test', metrics), ('int8', int8)):
            with open(os.path.join(work, name, 'metrics.json')) as f:
                m.update(json.load(f))
            check(np.isfinite(m['mAP']) and np.isfinite(m['NOS']),
                  f'CLI metrics {m}')
        with open(os.path.join(work, 'train.log.json')) as f:
            env = json.loads(f.readline())
        calibrated = [line for line in outs[2].splitlines()
                      if line.startswith('int8 tier: calibrated')]
        check(len(calibrated) == 1, 'tools.test --int8 printed no '
              'calibration line')
        check(env['device'].startswith('cuda'), f'tools.train ran on {env}')
        print(f'[19 CLIs] tools.train ({env["device_name"]}) '
              f'{times[0]:.1f} s and tools.test --eval {times[1]:.1f} s '
              f'(whole processes): mAP {metrics["mAP"]:.4f}, NOS '
              f'{metrics["NOS"]:.4f}; tools.test --int8 --eval '
              f'{times[2]:.1f} s: {calibrated[0]}, mAP {int8["mAP"]:.4f}, '
              f'NOS {int8["NOS"]:.4f}')
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

def _small_mtl_config(mode, crops=False):
    """BEVFusion-OCC at a small size (sorted pillars, no frozen backbone
    BN, 12 classes over 4 z bins) with a 16x16 BEV at 1 m, so that the task
    trunks' stride-8 stage keeps 2x2 cells (at 1x1 with batch 2 its
    train-mode BatchNorms normalise two values, an ill-conditioned
    gradient); ``crops``: detection shifted by half a cell, occupancy at
    0.5 m over a 12 x 8 m window."""
    import dataclasses

    from omnihd_scenes_tpu_torch.config import MTLConfig

    base = _small_config()
    fusion = dataclasses.replace(
        base, frozen_backbone_bn=False,
        lss=dataclasses.replace(base.lss, grid=1.0),
        pillars=dataclasses.replace(
            base.pillars, pillar_impl='sorted', voxel_size=(0.5, 0.5, 8.0),
            bev_hw=(32, 32), max_voxels=512, max_points_per_voxel=8))
    grids = {}
    if crops:
        grids = dict(grid_conf=((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0)),
                     det_grid_conf=((-7.5, 8.5, 1.0), (-8.5, 7.5, 1.0)),
                     occ_grid_conf=((-6.0, 6.0, 0.5), (-4.0, 4.0, 0.5)))
    return MTLConfig(fusion=fusion, occ_dz=4, trunk_mode=mode, **grids)


def _small_parity(dev, cfg, mtype, seed, label):
    """``cfg``'s model at a small size, f32 on the GPU against the CPU
    (TF32 off): eval-mode network outputs within 1e-4 of max|ref| (weights
    as drawn), the occupancy argmax equal wherever the CPU's top two
    logits differ by more than 1e-5 of max|logit|, and one train step's
    loss within 1e-5 and gradient within 1e-4 in relative L2 (BatchNorm
    biases +4).  Returns the (worst map error, differing argmax voxels,
    all voxels)."""
    import torch

    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict,
                                                         random_train_batch)

    sd = random_state_dict(cfg, seed)
    req = random_request(np.random.RandomState(seed), cfg, batch=2,
                         n_points=600)
    outs = [{k: v.float().cpu() for k, v in Predictor(
        cfg, sd, device=d, dtype=torch.float32).forward(*req).items()
        if v is not None} for d in (dev, 'cpu')]
    out_g, out_c = outs
    worst = 0.0
    for k, want in out_c.items():
        rel = float((out_g[k] - want).abs().max() / want.abs().max())
        check(rel <= 1e-4, f'{label} GPU vs CPU {k}: {rel:.3e} of max|ref|')
        worst = max(worst, rel)
    differ = total = 0
    if 'occ_logits' in out_c:
        logits = out_c['occ_logits']
        a_g, a_c = out_g['occ_logits'].argmax(-1), logits.argmax(-1)
        top2 = logits.topk(2, -1).values
        near = (top2[..., 0] - top2[..., 1]) <= 1e-5 * float(
            logits.abs().max())
        differ, total = int((a_g != a_c).sum()), a_c.numel()
        check(bool(near[a_g != a_c].all()), f'{label}: the occupancy argmax '
              f'differs away from a near-tie')
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'bias'] += 4.0
    batch = random_train_batch(np.random.RandomState(seed), cfg, 2,
                               n_points=600, max_gt=8)
    batch['gt_boxes'][..., :2] /= 5          # inside the small grid
    (l_c, n_c, g_c, _), (l_g, n_g, g_g, _) = _small_step_runs(
        dev, cfg, sd, batch, mtype)
    rel_loss = abs(l_g - l_c) / abs(l_c)
    rel_grad = _relative_l2(g_g, g_c)
    print(f'[{label}] GPU vs CPU f32: maps within {worst:.2e} of max|ref|; '
          f'occupancy argmax differs in {differ} of {total} voxels (each a '
          f'near-tie); train step loss {l_g:.5f} vs {l_c:.5f} '
          f'({rel_loss:.1e}), gradient {rel_grad:.1e} relative L2, LSS '
          f'backward launches CPU {n_c} GPU {n_g}')
    check(n_c == 0 and n_g == 1, f'{label}: backward launches {n_c}, {n_g}')
    check(rel_loss <= 1e-5 and rel_grad <= 1e-4,
          f'{label}: train step off ({rel_loss}, {rel_grad})')
    return worst, differ, total


def phase_mtl_small(dev):
    """BEVFusion-OCC small, GPU vs CPU, every trunk mode, 'per_task'
    behind non-identity grid crops."""
    for seed, (mode, crops) in enumerate((('none', False),
                                          ('per_task', True),
                                          ('shared', False))):
        _small_parity(dev, _small_mtl_config(mode, crops), 'bevfusion_mtl',
                      seed + 10, f'20 MTL small, trunk_mode={mode!r}'
                      + (', grid crops' if crops else ''))


def _timed_requests(dev, predictor, requests):
    """Run ``requests`` through ``predictor`` (the first a warm-up):
    (device ms of each timed one by CUDA events, lss_sample_bev launches
    after each request, peak GiB allocated, the last outputs)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                            lss_sample_bev)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    lss_sample_bev.launches = lss_sample.launches = 0
    dev_ms, counts, outs = [], [], []
    for req in requests:
        start.record()
        out = predictor(*req)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        counts.append(lss_sample_bev.launches)
        outs.append(out)
    check(counts == list(range(1, len(requests) + 1))
          and lss_sample.launches == 0,
          f'lss_sample_bev launches after each request {counts}, not one '
          f'per request')
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return dev_ms[1:], counts, peak, outs


def phase_mtl_serving(dev, card, bf16_ms):
    """BEVFusion-OCC serving at full width (``bench.py --mtl``'s model:
    the serving configuration inside ``MTLConfig``), b4 bf16, 1 warm-up
    and N_TIMED timed requests of fresh inputs: ms, samples/s, peak GiB,
    one LSS launch per request, the (4, 240, 160, 16) occupancy argmax on
    the card, its values in the class range and moving with the input."""
    import torch

    from omnihd_scenes_tpu_torch.config import MTLConfig, serving_config
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    cfg = MTLConfig(fusion=serving_config())
    t0 = time.perf_counter()
    predictor = Predictor(cfg, random_state_dict(cfg, seed=0), device=dev,
                          dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(21)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    dev_ms, counts, peak, outs = _timed_requests(dev, predictor, requests)
    nx, ny, _ = cfg.fusion.lss.bev_nx
    for boxes, scores, labels, valid, occ in outs:
        check(tuple(boxes.shape) == (BATCH, 500, 9)
              and bool(torch.isfinite(boxes).all()), 'MTL decode')
        check(tuple(occ.shape) == (BATCH, nx, ny, cfg.occ_dz)
              and occ.is_cuda and occ.dtype == torch.int64,
              f'occupancy grid {tuple(occ.shape)} {occ.dtype} {occ.device}')
        check(0 <= int(occ.min()) and int(occ.max()) < cfg.occ_classes,
              'occupancy classes out of range')
    moved = float((outs[-1][4] != outs[-2][4]).float().mean())
    check(moved > 0, 'the occupancy argmax did not move with the input')
    classes = int(torch.unique(outs[-1][4]).numel())
    ms = float(np.mean(dev_ms))
    print(f'[21 MTL serving] b{BATCH} bf16 x {N_TIMED} requests (+1 '
          f'warm-up), BEVFusion-OCC at full width: {ms:.2f} ms/request by '
          f'CUDA events ({dev_ms}), {BATCH * 1e3 / ms:.3f} samples/s, '
          f'{ms - bf16_ms:+.2f} ms against phase 5\'s BEVFusion request; '
          f'peak {peak:.2f} GiB allocated ({card}); occupancy argmax '
          f'{tuple(outs[-1][4].shape)} on the card, {classes} classes, '
          f'{moved:.3f} of voxels moved between the last two requests; '
          f'lss_sample_bev launches after each request {counts}; setup '
          f'{setup_s:.1f} s')
    del predictor, outs
    torch.cuda.empty_cache()
    return counts[0]


def _train_from_config(dev, card, path, label):
    """1 + N_TIMED b4 bf16-policy train steps of the model a shipped
    config builds, seeded random weights; losses must fall."""
    import torch

    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)
    from omnihd_scenes_tpu_torch.train.config import Config

    model, mtype = build_model_from_cfg(Config.fromfile(path))
    sd = init_model(model, torch.Generator().manual_seed(0)).state_dict()
    cfg = model.cfg
    del model
    _, (back, fwd) = phase_train(dev, card, BATCH, sd, cfg=cfg, mtype=mtype,
                                 label=label, falling=True)
    return {'train_fwd': fwd, 'train_back': back}


def phase_rcfusion(dev, card):
    """RCFusion: small GPU vs CPU parity, 1 + N_TIMED full-width b4 bf16
    requests (the serving configuration with the cross-modal fuser) and
    1 + N_TIMED b4 training steps of ``configs/rcfusion.py``."""
    import dataclasses

    import torch

    from omnihd_scenes_tpu_torch.config import serving_config
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    small = dataclasses.replace(_small_mtl_config('none').fusion,
                                rc_fusion='cross_attention')
    _small_parity(dev, small, 'rcfusion', 30, '23 RCFusion small')
    cfg = dataclasses.replace(serving_config(), rc_fusion='cross_attention')
    predictor = Predictor(cfg, random_state_dict(cfg, seed=0), device=dev,
                          dtype=torch.bfloat16)
    rng = np.random.RandomState(23)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    dev_ms, counts, peak, outs = _timed_requests(dev, predictor, requests)
    boxes, scores, labels, valid = outs[-1]
    check(tuple(boxes.shape) == (BATCH, 500, 9)
          and bool(torch.isfinite(boxes).all()), 'RCFusion decode')
    print(f'[23 RCFusion request] b{BATCH} bf16 x {N_TIMED} requests (+1 '
          f'warm-up; the serving configuration with the cross-modal fuser): '
          f'{float(np.mean(dev_ms)):.2f} ms/request by CUDA events '
          f'({dev_ms}), peak {peak:.2f} GiB allocated, {int(valid.sum())} '
          f'boxes kept, lss_sample_bev launches after each request {counts} '
          f'({card})')
    del predictor, outs
    torch.cuda.empty_cache()
    out = _train_from_config(dev, card, 'configs/rcfusion.py',
                             '23 RCFusion train step')
    out['request'] = counts[0]
    return out


BEVFORMER_SMALL = 'configs/synthetic/bevformer_synth.py'
BEVFORMER_FULL = 'configs/bevformer_t_r50.py'
BEVFORMER_TIMED = 6
BEVFORMER_STREAMS = 4
BEVFORMER_CAP = 0.375                     # the root bench's serving cap


def _bevformer_cfg(path):
    """The BEVFormerConfig that ``build_model_from_cfg`` builds from a
    shipped config."""
    from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
    from omnihd_scenes_tpu_torch.train.config import Config

    model, mtype = build_model_from_cfg(Config.fromfile(path))
    check(mtype == 'bevformer', f'{path} builds {mtype}')
    return model.cfg


def _run_stream(predictor, frames, has_prev, bev=None, timed=False):
    """Frames through a StreamPredictor, each frame's BEV fed back on the
    card.  Returns (the last frame's dets, its BEV, device ms per frame
    when ``timed``, MSDA calls per frame, host ms to launch each frame
    when ``timed``)."""
    import torch

    from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
        multi_scale_deformable_attn as msda)

    if bev is None:
        bev = predictor.zero_bev(frames[0][0].shape[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms, calls, host = [], [], []
    for frame, hp in zip(frames, has_prev):
        msda.calls = 0
        if timed:
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
        dets, bev = predictor(*frame, bev, hp)
        if timed:
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        calls.append(msda.calls)
    return dets, bev, ms, calls, host


@contextlib.contextmanager
def _decoder_positions_in_bf16(model):
    """Control fault: each decoder layer samples the BEV at its reference
    points rounded to bf16 (the port keeps sampling positions f32)."""
    import torch

    def pre(module, args):
        return args[:2] + (args[2].to(torch.bfloat16).float(),) + args[3:]

    handles = [layer.cross_attn.register_forward_pre_hook(pre) for layer in
               model.pts_bbox_head.transformer.decoder.layers]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _branches_in_fp8(model):
    """Control fault: the class and box branches' weight matrices rounded
    to float8 e4m3, scaled per matrix."""
    import torch

    head = model.pts_bbox_head
    mats = [p for p in (*head.cls_branches.parameters(),
                        *head.reg_branches.parameters()) if p.dim() == 2]
    saved = [p.detach().clone() for p in mats]
    with torch.no_grad():
        for p in mats:
            scale = p.float().abs().max() / 448
            p.copy_((p.float() / scale).to(torch.float8_e4m3fn).float()
                    * scale)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, w in zip(mats, saved):
                p.copy_(w)


# Faults that phase 24b's bf16-against-f32 check of the decoder layers must
# see.  Its limit, HEAD_TOL, lies between the sound bf16 reading and the
# controls': on one H100, 1.5e-2 against 6.5e-2 (fp8) and 1.6e-1 (PERF.md).
BEVFORMER_CONTROLS = {'decoder positions in bf16': _decoder_positions_in_bf16,
                      'branches in fp8': _branches_in_fp8}


def _share(got, want):
    """max|got - want| as a share of max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _stream_decoder(predictor, frames, has_prev, pre_hook=None):
    """The stream through ``predictor`` -> the last frame's decoder inputs
    (``args``), layer outputs (``hs``, B x L x nq x C) and references
    into each layer (``refs``), the head's class scores and box codes of
    every layer (``cls``, ``box``), decoded boxes and BEV.  ``pre_hook``
    may replace the decoder's inputs."""
    model = predictor.model
    decoder = model.pts_bbox_head.transformer.decoder
    seen = {}

    def keep_decoder(module, args, out):
        seen['args'], (seen['hs'], seen['refs']) = args, out

    def keep_head(module, args, out):
        seen['cls'], seen['box'] = out['all_cls_scores'], out['all_bbox_preds']

    handles = [decoder.register_forward_hook(keep_decoder),
               model.pts_bbox_head.register_forward_hook(keep_head)]
    if pre_hook is not None:
        handles.append(decoder.register_forward_pre_hook(pre_hook))
    try:
        seen['dets'], seen['bev'] = _run_stream(predictor, frames,
                                                has_prev)[:2]
    finally:
        for h in handles:
            h.remove()
    return seen


def _decoder_layers_alone(model, reference, seen):
    """Each decoder layer and branch pair of ``model`` on the inputs that
    the f32 ``reference`` stream (``seen``) gave that layer -> the largest
    shares of max|f32| over the layers of (the layer's output, the class
    scores, the raw box codes).  Fed the same inputs, the layers do not
    compound each other's rounding."""
    import torch

    head, ref_head = model.pts_bbox_head, reference.pts_bbox_head
    dtype = head.bev_embedding.dtype
    query, query_pos, bev, _, shapes, _ = seen['args']
    hs, refs = seen['hs'], seen['refs']
    errs = (0.0, 0.0, 0.0)
    with torch.inference_mode():
        for i, layer in enumerate(head.transformer.decoder.layers):
            x = query if i == 0 else hs[:, i - 1]
            out = layer(x.to(dtype), query_pos.to(dtype), bev.to(dtype),
                        refs[:, i, :, None, :2], shapes)
            h = hs[:, i]
            pairs = ((out, h),
                     (head.cls_branches[i](h.to(dtype)),
                      ref_head.cls_branches[i](h)),
                     (head.reg_branches[i](h.to(dtype)),
                      ref_head.reg_branches[i](h)))
            errs = tuple(max(e, _share(g, w))
                         for e, (g, w) in zip(errs, pairs))
    return errs


def phase_bevformer_small(dev):
    """(a) The synthetic config's model in f32 on the GPU against the CPU,
    3 frames with a scene boundary, each side carrying its own BEV."""
    import torch

    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_stream_frame)

    cfg = _bevformer_cfg(BEVFORMER_SMALL)
    sd = random_bevformer_state_dict(cfg, seed=24)
    rng = np.random.RandomState(24)
    frames = [random_stream_frame(rng, cfg, 2) for _ in range(3)]
    has_prev = [np.array([False, False]), np.array([True, True]),
                np.array([False, True])]
    out = {}
    for name, device in (('cpu', 'cpu'), ('gpu', dev)):
        predictor = StreamPredictor(cfg, sd, device=device,
                                    dtype=torch.float32)
        bev, rows = None, []
        for frame, hp in zip(frames, has_prev):
            dets, bev = _run_stream(predictor, [frame], [hp], bev)[:2]
            rows.append([t.cpu() for t in dets])
        out[name] = (bev.cpu(), rows)
    bev_err = float((out['gpu'][0] - out['cpu'][0]).abs().max()
                    / out['cpu'][0].abs().max())
    row_err = max(kept_row_distance(g, c, s)
                  for g, c in zip(out['gpu'][1], out['cpu'][1])
                  for s in range(2))
    print(f'[24a BEVFormer small] {BEVFORMER_SMALL} f32, 2 streams x 3 '
          f'frames (boundaries at frame 0 and, for stream 0, frame 2), GPU '
          f'vs CPU: last BEV within {bev_err:.3e} of max|ref|, kept rows '
          f'within {row_err:.3e} (limits 1e-4)')
    check(bev_err <= 1e-4 and row_err <= 1e-4,
          f'BEVFormer GPU vs CPU: BEV {bev_err:.3e}, rows {row_err:.3e}')


class _StageEvents:
    """CUDA events recorded before and after each named module's forward
    (forward hooks): the device ms between each pair, summed per name."""

    def __init__(self, modules):
        import torch

        self.events = {name: [] for name in modules}
        self.handles = []
        for name, mods in modules.items():
            for m in mods:
                self.handles.append(m.register_forward_pre_hook(
                    lambda mod, args, name=name: self._hook(name)))
                self.handles.append(m.register_forward_hook(
                    lambda mod, args, out, name=name: self._hook(name)))
        self._torch = torch

    def _hook(self, name):
        # A hook that returns a value replaces the module's inputs or
        # outputs; this one returns None.
        self.record(name)

    def record(self, name):
        e = self._torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name].append(e)
        return e

    def ms(self):
        return {name: sum(ev[i].elapsed_time(ev[i + 1])
                          for i in range(0, len(ev), 2))
                for name, ev in self.events.items()}

    def remove(self):
        for h in self.handles:
            h.remove()


def _msda_kind(value, shapes, loc):
    """'TSA', 'SCA' or 'decoder' from a call's shapes."""
    if loc.shape[4] == 8:
        return 'SCA'
    return 'TSA' if loc.shape[1] == value.shape[1] else 'decoder'


def _staged_frame(predictor, frame, bev, hp, capture, extra=None):
    """One more frame with the stage events and each MSDA call between
    two events; returns (stage ms, MSDA ms per kind, with ``capture`` a
    copy of one call's inputs per kind).  ``extra`` names more stages
    (name -> modules), whose summed ms join the split."""
    import torch

    from omnihd_scenes_tpu_torch.models.bevformer import attention

    model = predictor.model
    head = model.pts_bbox_head
    layers = head.transformer.encoder.layers
    stages = _StageEvents({
        'backbone': [model.img_backbone], 'FPN': [model.img_neck],
        'encoder': [head.transformer.encoder],
        'TSA': [l.tsa for l in layers], 'SCA': [l.sca for l in layers],
        'FFN': [l.ffn for l in layers],
        'decoder': [head.transformer.decoder], 'head': [head],
        **(extra or {}), '_frame': [], '_msda': []})
    msda = attention.multi_scale_deformable_attn
    calls, inputs = {}, {}

    def timed_msda(value, shapes, loc, wgt, *args, **kw):
        kind = _msda_kind(value, shapes, loc)
        if capture and kind not in inputs:
            inputs[kind] = (value.clone(), shapes, loc.clone(), wgt.clone())
        start = stages.record('_msda')
        out = msda(value, shapes, loc, wgt, *args, **kw)
        calls.setdefault(kind, []).append((start, stages.record('_msda')))
        return out

    attention.multi_scale_deformable_attn = timed_msda
    try:
        torch.cuda.synchronize()
        first = stages.record('_frame')
        predictor(*frame, bev, hp)
        last = stages.record('_frame')
        torch.cuda.synchronize()
    finally:
        attention.multi_scale_deformable_attn = msda
        stages.remove()
    ms = stages.ms()
    ev = stages.events
    split = {
        'upload': first.elapsed_time(ev['backbone'][0]),
        'backbone': ms['backbone'], 'FPN': ms['FPN'],
        'pre-encoder': ev['FPN'][-1].elapsed_time(ev['encoder'][0]),
        'encoder': ms['encoder'], 'TSA': ms['TSA'], 'SCA': ms['SCA'],
        'FFN': ms['FFN'], 'decoder': ms['decoder'],
        'branches': ev['decoder'][-1].elapsed_time(ev['head'][-1]),
        'decode': ev['head'][-1].elapsed_time(last),
        **{name: ms[name] for name in extra or {}},
        'frame': first.elapsed_time(last)}
    per_call = {k: [a.elapsed_time(b) for a, b in v]
                for k, v in calls.items()}
    return split, per_call, inputs


def _msda_cost(value, shapes, loc, wgt):
    """(operations, bytes) of one MSDA call: per sampled point 4 bilinear
    taps of head_dim values and the weighted sum (10 f32 operations per
    value); the value, the f32 locations and the weights read once, the
    output written once."""
    b, nq, nh, nl, p, _ = loc.shape
    hd = value.shape[-1]
    ops = 10 * b * nq * nh * nl * p * hd
    nbytes = (value.numel() * value.element_size()
              + loc.numel() * loc.element_size()
              + wgt.numel() * wgt.element_size()
              + b * nq * nh * hd * value.element_size())
    return ops, nbytes


def _grid_sample_ms(value, shapes, loc, wgt):
    """``F.grid_sample`` alone on the same inputs: the sampling that the
    plain MSDA does per level and chunk, without the weighted sum."""
    import torch.nn.functional as F

    from omnihd_scenes_tpu_torch.ops import ms_deform_attn as m

    b, nq, nh, _, p, _ = loc.shape
    hd = value.shape[-1]
    chunk = max(256, m.CHUNK_ELEMENTS // max(b * nh * p * hd, 1))
    levels = m._level_values(value, shapes)
    grids = [[loc[:, s:s + chunk, :, lvl].float().permute(0, 2, 1, 3, 4)
              .reshape(b * nh, -1, p, 2) * 2.0 - 1.0
              for s in range(0, nq, chunk)] for lvl in range(len(levels))]

    def run():
        for v, gs in zip(levels, grids):
            for g in gs:
                F.grid_sample(v, g, mode='bilinear', padding_mode='zeros',
                              align_corners=False)

    return cuda_ms(run, iters=10, warmup=2)


def _msda_table(inputs, per_call, calls_per_frame, card, label='24b MSDA'):
    """Each MSDA shape alone: ms, the bound, plain F.grid_sample; printed
    as one JSON line."""
    from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
        multi_scale_deformable_attn as msda)
    from omnihd_scenes_tpu_torch.tools.roofline import bound

    rows = {}
    for kind in ('TSA', 'SCA', 'decoder'):
        value, shapes, loc, wgt = inputs[kind]
        ms = cuda_ms(lambda: msda(value, shapes, loc, wgt), iters=10,
                     warmup=2)
        ops, nbytes = _msda_cost(value, shapes, loc, wgt)
        bound_ms, by = bound(ops, 'f32', nbytes)
        rows[kind] = {
            'value': list(value.shape), 'locations': list(loc.shape),
            'dtype': str(value.dtype).replace('torch.', ''),
            'calls_per_frame': len(per_call[kind]),
            'in_frame_ms': [round(x, 4) for x in per_call[kind]],
            'ms': ms, 'bound_ms': bound_ms, 'bound_by': by,
            'grid_sample_ms': _grid_sample_ms(value, shapes, loc, wgt)}
    total = sum(r['ms'] * r['calls_per_frame'] for r in rows.values())
    print(f'[{label}] ' + json.dumps({'card': card,
                                       'calls_per_frame': calls_per_frame,
                                       'ms_per_frame_alone': total,
                                       'shapes': rows}))
    return rows


def phase_bevformer_stream(dev, card):
    """(b) Full width, one bf16 stream; (c) four streams."""
    import dataclasses

    import torch

    from omnihd_scenes_tpu_torch.models.bevformer import sca_overflow_for_rig
    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_stream_frame)
    from omnihd_scenes_tpu_torch.utils.rig import ring_rig_lidar2img

    cfg = _bevformer_cfg(BEVFORMER_FULL)
    t0 = time.perf_counter()
    sd = random_bevformer_state_dict(cfg, seed=0)
    predictor = StreamPredictor(cfg, sd, device=dev, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(240)
    n = 1 + BEVFORMER_TIMED
    frames = [random_stream_frame(rng, cfg, 1) for _ in range(n)]
    has_prev = [np.array([i > 0]) for i in range(n)]
    want_calls = cfg.encoder_layers * (1 + cfg.num_cams) + cfg.decoder_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dets, bev, ms, calls, host = _run_stream(predictor, frames, has_prev,
                                             timed=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    boxes, scores, labels, valid = dets
    check(tuple(boxes.shape) == (1, 300, 9) and boxes.is_cuda
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all()), 'BEVFormer decode')
    check(tuple(bev.shape) == (1, cfg.bev_h * cfg.bev_w, cfg.embed_dims)
          and bev.dtype == torch.bfloat16 and bev.is_cuda
          and bool(torch.isfinite(bev).all()), 'BEVFormer BEV')
    check(calls == [want_calls] * n,
          f'MSDA calls per frame {calls}, not {want_calls}')
    timed = ms[1:]
    mean = float(np.mean(timed))
    host_ms = float(np.mean(host[1:]))
    print(f'[24b BEVFormer stream] {BEVFORMER_FULL} bf16, one stream, '
          f'{BEVFORMER_TIMED} timed frames (+1 warm-up) of fresh images, '
          f'previous BEV on the card: {mean:.2f} ms/frame by CUDA events '
          f'({[round(x, 3) for x in timed]}), {1e3 / mean:.3f} samples/s, '
          f'peak {peak:.2f} GiB allocated ({card}); MSDA calls per frame '
          f'{calls[0]}; {int(valid.sum())} of 300 boxes in range; setup '
          f'{setup_s:.1f} s')

    # One frame whose inputs are already on the card, with PyTorch's
    # synchronisation check set to raise: the forward and the decode never
    # make the host wait for the card.
    frame = [torch.from_numpy(x).to(dev)
             for x in random_stream_frame(rng, cfg, 1)]
    hp = torch.ones(1, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        predictor(*frame, bev, hp)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    del frame
    # The first staged frame copies one call's inputs per MSDA shape (new
    # allocations); the second, whose split is kept, allocates as the
    # timed frames do.
    inputs = _staged_frame(predictor, random_stream_frame(rng, cfg, 1), bev,
                           np.array([True]), capture=True)[2]
    split, per_call, _ = _staged_frame(
        predictor, random_stream_frame(rng, cfg, 1), bev, np.array([True]),
        capture=False)
    print('[24b stage split] one more frame, ms by CUDA events (a stage\'s '
          'time includes the card waiting for the host to launch it): '
          + ', '.join(f'{k} {v:.3f}' for k, v in split.items())
          + f'; MSDA in the frame {sum(map(sum, per_call.values())):.3f} ms '
          f'over {sum(map(len, per_call.values()))} calls; host time to '
          f'launch a timed frame {host_ms:.2f} ms; a frame with its inputs '
          f'on the card ran with no host synchronisation ({card})')
    msda_rows = _msda_table(inputs, per_call, calls[0], card)
    del inputs

    l2i = ring_rig_lidar2img(img_hw=cfg.img_hw)
    capped = dataclasses.replace(cfg, sca_query_cap=BEVFORMER_CAP)
    overflow = sca_overflow_for_rig(capped, l2i)
    check(overflow == 0, f'SCA cap {BEVFORMER_CAP} drops {overflow} hit '
                         f'queries on the ring rig')
    layers = predictor.model.pts_bbox_head.transformer.encoder.layers
    for layer in layers:
        layer.sca.query_cap = BEVFORMER_CAP
    try:
        cap_dets, cap_bev, cap_ms = _run_stream(predictor, frames,
                                                has_prev, timed=True)[:3]
    finally:
        for layer in layers:
            layer.sca.query_cap = cfg.sca_query_cap
    cap_err = float((cap_bev.float() - bev.float()).abs().max()
                    / bev.float().abs().max())
    cap_match = box_match(cap_dets[0], cap_dets[2], cap_dets[3], boxes,
                          labels, valid)
    hits = sca_hits(cfg, l2i).tolist()
    print(f'[24b SCA cap] ring rig, hit queries per camera {hits} of '
          f'{cfg.bev_h * cfg.bev_w}; cap {BEVFORMER_CAP} '
          f'(k = {int(np.ceil(cfg.bev_h * cfg.bev_w * BEVFORMER_CAP))}) '
          f'drops {overflow}; served at {BEVFORMER_CAP}: '
          f'{float(np.mean(cap_ms[1:])):.2f} ms/frame against '
          f'{mean:.2f} at 1.0; last BEV within {cap_err:.3e} of max|1.0|, '
          f'{cap_match:.4f} of its boxes matched (limits {HEAD_TOL}, '
          f'{BOX_MATCH})')
    check(cap_err <= HEAD_TOL and cap_match >= BOX_MATCH,
          f'the stream served at cap {BEVFORMER_CAP} left the dense one: '
          f'BEV {cap_err:.3e}, boxes {cap_match:.4f}')

    reference = StreamPredictor(cfg, sd, device=dev, dtype=torch.float32)
    ref = _stream_decoder(reference, frames, has_prev)
    # The f32 decoder's own sensitivity: the same stream with only the
    # decoder's BEV input rounded to bf16.
    rounded = _stream_decoder(
        reference, frames, has_prev,
        lambda module, args: (args[:2] + (args[2].to(torch.bfloat16).float(),)
                              + args[3:]))
    got = _stream_decoder(predictor, frames, has_prev)
    layer_errs = {'bf16': _decoder_layers_alone(predictor.model,
                                                reference.model, ref)}
    for name, fault in BEVFORMER_CONTROLS.items():
        with fault(predictor.model):
            layer_errs[name] = _decoder_layers_alone(predictor.model,
                                                     reference.model, ref)
    del reference
    torch.cuda.empty_cache()
    bev_err = _share(got['bev'], ref['bev'])
    boxes, _, labels, valid = got['dets']
    ref_boxes, _, ref_labels, ref_valid = ref['dets']
    match = box_match(boxes, labels, valid, ref_boxes, ref_labels, ref_valid)

    def first_last(run, key):
        return ' / '.join(f'{_share(run[key][:, i], ref[key][:, i]):.3e}'
                          for i in (0, -1))

    print(f'[24b bf16 vs f32] after {n} frames, as shares of max|f32|: BEV '
          f'{bev_err:.3e}; each decoder layer and its branches alone on the '
          f'f32 stream\'s inputs, the largest over the layers of output / '
          f'class scores / box codes: ' + ', '.join(
              f'{name} ' + ' / '.join(f'{e:.3e}' for e in errs)
              for name, errs in layer_errs.items())
          + f' (limit {HEAD_TOL} on the BEV and the layers, which each '
          f'control must exceed). Not checked: the streamed decoder\'s '
          f'class scores and box codes at its first / last layer, bf16 '
          f'{first_last(got, "cls")} and {first_last(got, "box")}, f32 with '
          f'its BEV input rounded to bf16 {first_last(rounded, "cls")} and '
          f'{first_last(rounded, "box")} (under random weights the '
          f'reference refinement compounds a rounding from layer to layer); '
          f'{match:.4f} of the {int(valid.sum())} bf16 boxes in range match '
          f'an f32 box of the same label (rotated BEV IoU >= 0.5)')
    check(bev_err <= HEAD_TOL and max(layer_errs['bf16']) <= HEAD_TOL,
          f'bf16 stream against f32: BEV {bev_err:.3e}, decoder layers '
          f'{layer_errs["bf16"]}')
    for name in BEVFORMER_CONTROLS:
        check(max(layer_errs[name]) > HEAD_TOL,
              f'the control "{name}" reads {layer_errs[name]}, inside the '
              f'limit {HEAD_TOL}: the check cannot see that fault')
    del ref, rounded, got

    b = BEVFORMER_STREAMS
    frames = [random_stream_frame(rng, cfg, b) for _ in range(1 + N_TIMED)]
    has_prev = [np.zeros(b, bool)] + [np.ones(b, bool)] * N_TIMED
    has_prev[2] = np.array([True, False, True, True])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dets, bev4, ms4, calls4, host4 = _run_stream(predictor, frames,
                                                 has_prev, timed=True)
    peak4 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(tuple(dets[0].shape) == (b, 300, 9)
          and bool(torch.isfinite(dets[0]).all())
          and bool(torch.isfinite(bev4).all()), 'BEVFormer b4 outputs')
    check(calls4 == [want_calls] * len(frames), f'b4 MSDA calls {calls4}')
    mean4 = float(np.mean(ms4[1:]))
    print(f'[24c BEVFormer streams] {b} scene-parallel bf16 streams, '
          f'{N_TIMED} timed frames (+1 warm-up; stream 1 at a scene '
          f'boundary in frame 2): {mean4:.2f} ms/frame '
          f'({[round(x, 3) for x in ms4[1:]]}), {b * 1e3 / mean4:.3f} '
          f'samples/s, peak {peak4:.2f} GiB allocated, {peak4 / b:.2f} GiB '
          f'per stream; host time to launch a frame '
          f'{float(np.mean(host4[1:])):.2f} ms ({card})')
    # The MSDA table again with the root bench's plain init: zero offset
    # and weight kernels, so each query samples the grid-init pattern
    # around its reference with equal weights.
    with torch.no_grad():
        for name, p in predictor.model.named_parameters():
            if name.endswith(('sampling_offsets.weight',
                              'attention_weights.weight')):
                p.zero_()
    _, zero_calls, zero_inputs = _staged_frame(
        predictor, random_stream_frame(rng, cfg, 1), bev, np.array([True]),
        capture=True)
    _msda_table(zero_inputs, zero_calls, calls[0], card,
                '24b MSDA, zero offset and weight kernels')
    del predictor, frames, zero_inputs
    torch.cuda.empty_cache()
    return {'b1_ms': mean, 'b1_peak': peak, 'b4_ms': mean4,
            'b4_peak': peak4, 'split': split, 'msda': msda_rows}


BEVFORMER_R101 = 'configs/bevformer_t_r101.py'
DCN_STAGES = (False, False, True, True)
QUEUE_GT = 40                  # valid GTs of 128 per full-width sample
# Phases 25a / 26a hold each gradient leaf of the card's f32 step to the
# CPU's f32 step within this share of the leaf's max|CPU|.  A ReLU input or
# a max-pool window within an f32 rounding of its kink can fall on either
# side in two f32 runs, and the side moves the gradient of everything
# upstream: at 26a's weights the CPU's f32 step cuts ReLU units whose f64
# input is ~1e-6, and its gradient then differs from the card's by 4.3e-2
# of a leaf's max.  So both f32 steps take the side that the CPU's f64
# step took at every ReLU and max-pool of the forward with gradients
# (``_kink_sides``), and the phase prints how many sides the CPU's f32
# step takes otherwise and what that costs.  The decoder self-attention's
# key biases, whose gradient is 0 in exact arithmetic (the softmax removes
# a bias common to every key), are held within 1e-6 of the gradient's
# largest element instead.
GRAD_SHARE = 1e-3


def _kernel_launches():
    """The launch count of every hand kernel's wrapper."""
    from omnihd_scenes_tpu_torch.kernels.bconv import bconv3x3
    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip)
    from omnihd_scenes_tpu_torch.kernels.jpeg_idct import jpeg_idct
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample, lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.kernels.photometric import photometric
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    return {'lss_sample': lss_sample_bev, 'lss_sample_backward':
            lss_sample_bev_backward, 'lss_sample_fields_in': lss_sample,
            'qconv': qconv3x3, 'bconv': bconv3x3, 'rectify': R.rectify,
            'rectify_pack_map': R.pack_map,
            # One launch makes both tables: one count, two rows.
            'rectify_footprint': R.geometry_tables,
            'rectify_taps': R.geometry_tables, 'jpeg_idct': jpeg_idct,
            'photometric': photometric, 'crop_resize_flip': crop_resize_flip}


def _zero_launches():
    for fn in _kernel_launches().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _kernel_launches().items()}


class _MatchProbe:
    """Wraps the DETR loss's matcher: CUDA events around each call, the
    host ms of scipy's solve, and the matches (on the CPU)."""

    def __init__(self, keep=False):
        import torch

        from omnihd_scenes_tpu_torch.models import hungarian
        from omnihd_scenes_tpu_torch.models.bevformer import loss

        self._torch, self._loss, self._hm = torch, loss, hungarian
        self.keep, self.matches, self.events, self.host_ms = keep, [], [], []

    def __enter__(self):
        match, solve = self._loss.hungarian_match, self._hm.solve_host

        def timed_match(*args, **kw):
            start = self._event()
            out = match(*args, **kw)
            self.events.append((start, self._event()))
            if self.keep:
                self.matches.append(out[0].cpu())
            return out

        def timed_solve(cost):
            t0 = time.perf_counter()
            out = solve(cost)
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self._saved = match, solve
        self._loss.hungarian_match, self._hm.solve_host = (timed_match,
                                                           timed_solve)
        return self

    def __exit__(self, *exc):
        self._loss.hungarian_match, self._hm.solve_host = self._saved

    def _event(self):
        if not self._torch.cuda.is_available():
            return None
        e = self._torch.cuda.Event(enable_timing=True)
        e.record()
        return e


def _bevformer_train_state(cfg, sd, device, lr=2e-4):
    import torch

    from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
    from omnihd_scenes_tpu_torch.train.loop import create_train_state
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    model = BEVFormerDetector(cfg)
    model.load_state_dict(sd)
    model.to(device, memory_format=torch.channels_last)
    return create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(lr, 1000, warmup_iters=0), 0.01, 35.0))


def _kink_sides(recorded=None):
    """A TorchFunctionMode that, where autograd records, keeps the input of
    each ``F.relu`` and the argmax of each ``F.max_pool2d`` in ``.sides``
    (``recorded`` None), or imposes ``recorded``: a ReLU passes where the
    recorded input was > 0, a max-pool reads the recorded argmax."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class KinkSides(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.sides, self.used = [] if recorded is None else recorded, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in (F.relu, F.max_pool2d) or \
                    not torch.is_grad_enabled():
                return func(*args, **kwargs)
            x = args[0]
            if func is F.relu:
                if recorded is None:
                    self.sides.append(x.detach().cpu())
                    return func(*args, **kwargs)
                side = self.sides[self.used].to(x.device) > 0
                self.used += 1
                return torch.where(side, x, torch.zeros_like(x))
            out, idx = func(*args, **{**kwargs, 'return_indices': True})
            if recorded is None:
                self.sides.append(idx.cpu())
                return out
            idx = self.sides[self.used].to(x.device)
            self.used += 1
            return x.flatten(2).gather(2, idx.flatten(2)).view_as(idx)

    return KinkSides()


def _bevformer_step_runs(dev, cfg, sd, batch):
    """One train step of ``cfg``'s model from ``sd``: the CPU's in f64,
    recording its kink sides; the CPU's in f32 as it falls, recording its
    own; then the CPU's and twice the card's in f32 on the f64 step's
    sides.  Each run: (loss, aux, matches per call, gradients, sides)."""
    import torch

    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import make_train_step

    out, exact = [], None
    for where in ('cpu64', 'cpu', 'cpu', 'gpu', 'gpu'):
        state = _bevformer_train_state(cfg, sd, dev if where == 'gpu'
                                       else 'cpu')
        b = batch
        if where == 'cpu64':
            state.model.double()
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
        grads = {}
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
                 for k, p in state.model.named_parameters()]
        sides = _kink_sides(exact if len(out) > 1 else None)
        with _MatchProbe(keep=True) as probe, sides:
            _, loss, aux = make_train_step(make_loss_fn_generic(
                state.model, 'bevformer', None))(state, b)
        for h in hooks:
            h.remove()
        if len(out) > 1:
            check(sides.used == len(exact),
                  f'{sides.used} kink sides imposed of {len(exact)}')
        elif exact is None:
            exact = sides.sides
        out.append((float(loss), {k: float(v) for k, v in aux.items()},
                    probe.matches, {k: v.to('cpu', torch.float64)
                                    for k, v in grads.items()},
                    sides.sides))
    return out


def _gaps(ref, grads):
    """The worst leaf of ``grads`` against ``ref`` as a share of the
    leaf's max|ref| (the zero-gradient key biases left out)."""
    return max((float((grads[k] - g).abs().max() / g.abs().max()), k)
               for k, g in ref.items()
               if not k.endswith('self_attn.key.bias'))


def _check_step_parity(tag, what, runs):
    """Runs of ``_bevformer_step_runs``: the card's matches equal the
    CPU's, its loss within 1e-5 of |loss|, each gradient leaf held to the
    CPU's f32 step on the same kink sides as ``GRAD_SHARE`` says; the two
    card runs equal in matches and losses (not in gradients:
    ``F.grid_sample``'s backward adds with atomics)."""
    exact, plain, (loss, aux, matches, cpu, _), *gpu = runs
    top = max(float(g.abs().max()) for g in cpu.values())
    worst = (0.0, '')
    for g_loss, g_aux, g_matches, g_grads, _ in gpu:
        check(len(g_matches) == len(matches) and all(
            bool((a == b).all()) for a, b in zip(g_matches, matches)),
              f'{tag}: GPU matches differ from the CPU\'s')
        check(abs(g_loss - loss) <= 1e-5 * abs(loss),
              f'{tag}: loss {g_loss} against {loss}')
        for k, g in cpu.items():
            err = float((g_grads[k] - g).abs().max())
            if k.endswith('self_attn.key.bias'):
                check(err <= 1e-6 * top, f'{tag}: {k} off by {err}')
                continue
            share = err / float(g.abs().max())
            check(share <= GRAD_SHARE, f'{tag}: gradient leaf {k}: GPU '
                  f'{share:.3e} of its max|CPU| off')
            worst = max(worst, (share, k))
    (l1, a1, m1, _, _), (l2, a2, m2, _, _) = gpu
    same_aux = all(a1[k] == a2[k] for k in ('loss_cls', 'loss_bbox'))
    check(l1 == l2 and same_aux and all(bool((a == b).all())
                                        for a, b in zip(m1, m2)),
          f'{tag}: two GPU steps differ ({l1} / {l2})')
    # The CPU's f32 step as it falls: the ReLU units and max-pool outputs
    # on the other side of the f64 step's, and the largest |f64 input|
    # among those units.
    relu = [(e > 0) != (p > 0) for e, p in zip(exact[4], plain[4])
            if e.is_floating_point()]
    cut = sum(int(m.sum()) for m in relu)
    margin = max([float(e[m].abs().max()) for e, m in zip(
        [e for e in exact[4] if e.is_floating_point()], relu) if m.any()],
        default=0.0)
    pools = sum(int((e != p).sum()) for e, p in zip(exact[4], plain[4])
                if not e.is_floating_point())
    n_layers = matches[0].shape[1]
    plain_gap, on_sides, card_gap = (_gaps(exact[3], g) for g in (
        plain[3], cpu, gpu[0][3]))
    print(f'[{tag}] {what}: loss CPU {loss:.6f} / GPU {gpu[0][0]:.6f} '
          f'(limit 1e-5 of |loss|); matches of all {n_layers} decoder '
          f'layers equal on both devices and on two GPU runs, whose losses '
          f'are bit-equal; on the f64 step\'s sides of {len(exact[4])} '
          f'ReLUs and max-pools, the worst gradient leaf of the GPU\'s f32 '
          f'step {worst[0]:.3e} of its max|CPU f32| ({worst[1]}; limit '
          f'{GRAD_SHARE}); against the f64 step, the worst leaf of the '
          f'GPU\'s f32 step {card_gap[0]:.3e} ({card_gap[1]}), of the CPU\'s '
          f'{on_sides[0]:.3e} ({on_sides[1]}); the CPU\'s f32 step on its '
          f'own sides: {cut} ReLU unit(s) on the other side of f64\'s '
          f'(largest |f64 input| {margin:.3e}), {pools} max-pool output(s) '
          f'from another input, worst leaf {plain_gap[0]:.3e} of its '
          f'max|f64| ({plain_gap[1]})')


def phase_bevformer_train_small(dev):
    """(25a) One f32 train step of the synthetic config's model, GPU
    against CPU."""
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_queue_batch)

    cfg = _bevformer_cfg(BEVFORMER_SMALL)
    sd = random_bevformer_state_dict(cfg, seed=25)
    batch = random_queue_batch(np.random.RandomState(25), cfg, 2, n_gt=10,
                               max_gt=16)
    _zero_launches()
    runs = _bevformer_step_runs(dev, cfg, sd, batch)
    _check_step_parity('25a BEVFormer train small',
                       f'{BEVFORMER_SMALL} f32, B=2, queue '
                       f'{cfg.queue_length}, 10 of 16 GTs, TF32 off', runs)
    check(not any(_read_launches().values()), 'a hand kernel launched')


def _stage_split(marks, backbone_events, probe):
    """The staged step's split (ms) from its CUDA events."""
    start, forward, loss, backward, opt = (marks[k] for k in (
        'start', 'forward', 'loss', 'backward', 'optimizer'))
    last = backbone_events[-1]
    match = sum(a.elapsed_time(b) for a, b in probe.events)
    return {'history replay': start.elapsed_time(last),
            'last-frame forward': last.elapsed_time(forward),
            'matching': match,
            'matching host (scipy)': sum(probe.host_ms),
            'loss without matching': forward.elapsed_time(loss) - match,
            'backward': loss.elapsed_time(backward),
            'optimizer': backward.elapsed_time(opt),
            'step': start.elapsed_time(opt)}


def phase_bevformer_train(dev, card):
    """(25b) configs/bevformer_t_r50.py at full width: bf16-policy steps."""
    import warnings

    import torch

    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_queue_batch)
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import batch_to, make_train_step

    cfg = _bevformer_cfg(BEVFORMER_FULL)
    t0 = time.perf_counter()
    state = _bevformer_train_state(cfg, random_bevformer_state_dict(cfg, 0),
                                   dev)
    setup_s = time.perf_counter() - t0
    marks = {}

    def mark(stage):
        marks[stage] = torch.cuda.Event(enable_timing=True)
        marks[stage].record()

    step = make_train_step(bf16_policy(make_loss_fn_generic(
        state.model, 'bevformer', None, mark=mark)), mark=mark)
    rng = np.random.RandomState(250)

    def fresh_batch():
        return batch_to(random_queue_batch(rng, cfg, 1, n_gt=QUEUE_GT), dev)

    _zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms, losses = [], []
    for i in range(1 + N_TIMED):
        batch = fresh_batch()
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        start.record()
        _, loss, aux = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append((float(loss), float(aux['loss_cls']),
                       float(aux['loss_bbox']), float(aux['grad_norm'])))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(all(np.isfinite(x).all() for x in losses),
          f'non-finite BEVFormer loss or gradient norm {losses}')
    check(all(bool(torch.isfinite(p).all())
              for p in state.model.parameters()), 'non-finite parameters')
    mean = float(np.mean(ms[1:]))

    # One more step with the stage events: the backbone's forward pre-hook
    # marks each frame's start, so its last call starts the last frame.
    backbone_events = []

    def frame_start(module, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        backbone_events.append(e)

    hook = state.model.img_backbone.register_forward_pre_hook(frame_start)
    batch = fresh_batch()
    torch.cuda.synchronize()
    mark('start')
    try:
        with _MatchProbe() as probe:
            step(state, batch)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    check(len(backbone_events) == cfg.queue_length,
          f'{len(backbone_events)} backbone calls for a queue of '
          f'{cfg.queue_length}')
    split = _stage_split(marks, backbone_events, probe)

    # One more step with PyTorch's synchronisation check warning at each
    # place the host waits for the card.
    batch = fresh_batch()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if 'called a synchronizing CUDA operation' in str(w.message)]
    launches = _read_launches()
    print(f'[25b BEVFormer train] {BEVFORMER_FULL} at full width (R50 + '
          f'FPN, 6 x {cfg.img_hw[0]}x{cfg.img_hw[1]}, BEV {cfg.bev_h}x'
          f'{cfg.bev_w} x {cfg.embed_dims}, {cfg.num_query} queries, '
          f'{cfg.encoder_layers} + {cfg.decoder_layers} layers, queue '
          f'{cfg.queue_length}, B=1), bf16 policy, AdamW + clip 35, '
          f'{N_TIMED} timed steps (+1 warm-up) of fresh queues with '
          f'{QUEUE_GT} of 128 GTs: {mean:.2f} ms/step by CUDA events '
          f'({[round(x, 3) for x in ms[1:]]}), {1e3 / mean:.3f} samples/s, '
          f'peak {peak:.2f} GiB allocated ({card}); (loss, loss_cls, '
          f'loss_bbox, grad_norm) per step '
          f'{[tuple(round(v, 4) for v in x) for x in losses]}; setup '
          f'{setup_s:.1f} s')
    print('[25b stage split] one more step, ms by CUDA events (the matching '
          'includes the card idle while the host solves): '
          + ', '.join(f'{k} {v:.3f}' for k, v in split.items())
          + f'; {len(probe.events)} matcher call(s) for '
          f'{cfg.decoder_layers} layers x 1 sample')
    print(f'[25b host syncs] one more step under '
          f'torch.cuda.set_sync_debug_mode(\'warn\'): {len(syncs)} '
          f'synchronisation(s) {syncs} (expected 1: the matcher\'s copy of '
          f'the costs to the host); hand-kernel launches {launches}')
    check(len(probe.events) == 1, 'the matcher ran more than once a step')
    check(len(syncs) == 1, f'{len(syncs)} host syncs in a step: {syncs}')
    check(not any(launches.values()), f'a hand kernel launched: {launches}')
    del state, batch
    torch.cuda.empty_cache()
    return {'ms': mean, 'peak': peak, 'split': split, 'launches': launches}


def _dcn_config(path):
    import dataclasses

    cfg = _bevformer_cfg(path)
    return dataclasses.replace(cfg, stage_with_dcn=DCN_STAGES)


def phase_dcn_small(dev):
    """(26a) The synthetic model with DCNv2 on stages 3-4, f32: one
    frame's BEV and one train step, GPU against CPU."""
    import torch

    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        random_bevformer_state_dict, random_queue_batch, random_stream_frame)

    cfg = _dcn_config(BEVFORMER_SMALL)
    sd = random_bevformer_state_dict(cfg, seed=26)
    gen = torch.Generator().manual_seed(26)
    for k in [k for k in sd if k.endswith('conv_offset.bias')]:
        # Offsets of up to 2 pixels on 8x12 and 4x6 maps: taps leave them.
        sd[k] = torch.rand(sd[k].shape, generator=gen) * 4 - 2
    rng = np.random.RandomState(26)
    frame = random_stream_frame(rng, cfg, 2)
    bevs = []
    _zero_launches()
    for device in ('cpu', dev):
        predictor = StreamPredictor(cfg, sd, device=device,
                                    dtype=torch.float32)
        bevs.append(_run_stream(predictor, [frame], [np.array([False, True])],
                                predictor.zero_bev(2))[1].cpu())
    bev_err = float((bevs[1] - bevs[0]).abs().max() / bevs[0].abs().max())
    print(f'[26a R101-DCN small] {BEVFORMER_SMALL} with stage_with_dcn '
          f'{DCN_STAGES}, offset-conv biases over +-2 pixels, f32, 2 '
          f'streams: BEV GPU vs CPU within {bev_err:.3e} of max|ref| (limit '
          f'1e-4)')
    check(bev_err <= 1e-4, f'DCN BEVFormer GPU vs CPU: BEV {bev_err:.3e}')
    batch = random_queue_batch(rng, cfg, 2, n_gt=10, max_gt=16)
    _check_step_parity('26a R101-DCN train small',
                       'the same model, one f32 step',
                       _bevformer_step_runs(dev, cfg, sd, batch))
    _dcn_zero_offset_gradient(dev)
    check(not any(_read_launches().values()), 'a hand kernel launched')


def _dcn_zero_offset_gradient(dev):
    """One DCN layer with zero offset convs (every tap on a texel centre,
    ROADMAP queue 3 item 17): the offset conv's f32 gradient on the card
    against the CPU port's, both taking the floor side."""
    import torch

    from omnihd_scenes_tpu_torch.models.dcn import DeformConv

    gen = torch.Generator().manual_seed(260)
    x = torch.randn(2, 64, 17, 30, generator=gen)
    cot = torch.randn(2, 64, 9, 15, generator=gen)
    layer = DeformConv(64, 64, stride=2)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                           * 0.05)
    grads = []
    for device in ('cpu', dev):
        m = layer.to(device)
        for p in m.parameters():
            p.grad = None
        (m(x.to(device)) * cot.to(device)).sum().backward()
        grads.append({k: p.grad.detach().cpu().clone()
                      for k, p in m.named_parameters()
                      if k.startswith('conv_offset')})
    shares = {k: float((grads[1][k] - v).abs().max() / v.abs().max())
              for k, v in grads[0].items()}
    print(f'[26a DCN zero offsets] DeformConv 64 -> 64, stride 2, on '
          f'2x64x17x30, offset conv zero (every tap on a texel centre): '
          f'offset-conv gradient GPU vs CPU '
          + ', '.join(f'{k} {v:.3e}' for k, v in shares.items())
          + f' of max|CPU| (limit {GRAD_SHARE})')
    check(all(v <= GRAD_SHARE for v in shares.values()),
          f'DCN offset-conv gradient at texel centres GPU vs CPU {shares}')


def _dcn_cost(module, x):
    """(operations, bytes) of one DeformConv call on x (B, C, H, W): the
    offset conv's and the kernel's multiply-adds at the bf16 rate (the
    sampling's ~9 operations per tap and channel add under 2 %); x and the
    weights read once, the output written once."""
    b, c, h, w = x.shape
    s = module.stride
    oh, ow = -(-h // s), -(-w // s)
    f = module.weight.shape[0]
    ops = 2 * 9 * c * (27 + f) * b * oh * ow
    nbytes = (x.numel() + module.weight.numel()
              + module.conv_offset.weight.numel() + 27
              + b * f * oh * ow) * x.element_size()
    return ops, nbytes


def phase_r101_stream(dev, card):
    """(26b) configs/bevformer_t_r101.py at full width, one bf16 stream."""
    import torch

    from omnihd_scenes_tpu_torch.models.dcn import DeformConv
    from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (
        DCN_OFFSET_STD, random_bevformer_state_dict, random_stream_frame)

    cfg = _bevformer_cfg(BEVFORMER_R101)
    check(cfg.stage_with_dcn == DCN_STAGES and cfg.resnet_depth == 101,
          f'{BEVFORMER_R101}: {cfg.resnet_depth} {cfg.stage_with_dcn}')
    t0 = time.perf_counter()
    predictor = StreamPredictor(cfg, random_bevformer_state_dict(cfg, 0),
                                device=dev, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    dcn = [m for m in predictor.model.modules() if isinstance(m, DeformConv)]
    check(len(dcn) == 26, f'{len(dcn)} DCN layers, not 23 + 3')
    rng = np.random.RandomState(260)
    n = 1 + BEVFORMER_TIMED
    frames = [random_stream_frame(rng, cfg, 1) for _ in range(n)]
    has_prev = [np.array([i > 0]) for i in range(n)]
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dets, bev, ms, _, host = _run_stream(predictor, frames, has_prev,
                                         timed=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    boxes, scores, _, valid = dets
    check(tuple(boxes.shape) == (1, 300, 9)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all())
          and bool(torch.isfinite(bev).all()), 'R101-DCN outputs')
    mean = float(np.mean(ms[1:]))
    frame = [torch.from_numpy(x).to(dev)
             for x in random_stream_frame(rng, cfg, 1)]
    hp = torch.ones(1, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        predictor(*frame, bev, hp)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    del frame
    split = _staged_frame(predictor, random_stream_frame(rng, cfg, 1), bev,
                          np.array([True]), capture=False,
                          extra={'DCN layers': dcn})[0]
    print(f'[26b R101-DCN stream] {BEVFORMER_R101} at full width (ResNet-101 '
          f'with DCNv2 on stages 3-4, 6 x {cfg.img_hw[0]}x{cfg.img_hw[1]}, '
          f'BEV {cfg.bev_h}x{cfg.bev_w} x {cfg.embed_dims}), bf16, one '
          f'stream, {BEVFORMER_TIMED} timed frames (+1 warm-up): '
          f'{mean:.2f} ms/frame by CUDA events '
          f'({[round(x, 3) for x in ms[1:]]}), {1e3 / mean:.3f} samples/s, '
          f'peak {peak:.2f} GiB allocated '
          f'({card}); host time to launch a frame '
          f'{float(np.mean(host[1:])):.2f} ms; {int(valid.sum())} of 300 '
          f'boxes in range; a frame with its inputs on the card ran with no '
          f'host synchronisation; setup {setup_s:.1f} s')
    print('[26b stage split] one more frame, ms by CUDA events: '
          + ', '.join(f'{k} {v:.3f}' for k, v in split.items()))

    rows = _dcn_shapes(predictor, dcn, random_stream_frame(rng, cfg, 1), bev,
                       card, f'offset convs N(0, {DCN_OFFSET_STD})')
    # The frame and the shapes again at the init's zero offset convs (the
    # JAX package's DeformConv, mmcv's): every tap on its grid point.
    with torch.no_grad():
        for m in dcn:
            m.conv_offset.weight.zero_()
            m.conv_offset.bias.zero_()
    zero_ms = _run_stream(predictor, frames, has_prev, timed=True)[2]
    zero_mean = float(np.mean(zero_ms[1:]))
    zero_split = _staged_frame(predictor, random_stream_frame(rng, cfg, 1),
                               bev, np.array([True]), capture=False,
                               extra={'DCN layers': dcn})[0]
    print(f'[26b zero offsets] the same stream at zero offset-conv kernels: '
          f'{zero_mean:.2f} ms/frame by CUDA events '
          f'({[round(x, 3) for x in zero_ms[1:]]}) against {mean:.2f} at '
          f'N(0, {DCN_OFFSET_STD}); one more frame: backbone '
          f'{zero_split["backbone"]:.3f} ms, DCN layers '
          f'{zero_split["DCN layers"]:.3f}, frame {zero_split["frame"]:.3f} '
          f'({card})')
    zero_rows = _dcn_shapes(predictor, dcn, random_stream_frame(rng, cfg, 1),
                            bev, card, 'zero offset convs')
    launches = _read_launches()
    print(f'[26b launches] hand-kernel launches {launches}')
    check(not any(launches.values()), f'a hand kernel launched: {launches}')
    del predictor
    torch.cuda.empty_cache()
    return {'ms': mean, 'peak': peak, 'split': split, 'dcn': rows,
            'zero_ms': zero_mean, 'zero_dcn': zero_rows,
            'launches': launches}


def _dcn_shapes(predictor, dcn, frame, bev, card, label):
    """Each DCN layer shape of ``dcn`` alone on the input that one more
    frame gave it: ms by CUDA events beside the bound of
    ``tools/roofline.py`` (one JSON line)."""
    import torch

    from omnihd_scenes_tpu_torch.tools.roofline import bound

    seen = {}

    def keep(module, args):
        key = (tuple(args[0].shape), module.stride, module.weight.shape[0])
        seen.setdefault(key, (module, args[0].clone()))

    hooks = [m.register_forward_pre_hook(keep) for m in dcn]
    try:
        predictor(*frame, bev, np.array([True]))
    finally:
        for h in hooks:
            h.remove()
    rows = []
    with torch.inference_mode():
        for (shape, stride, f), (module, x) in seen.items():
            t = cuda_ms(lambda: module(x), iters=10, warmup=2)
            ops, nbytes = _dcn_cost(module, x)
            bound_ms, by = bound(ops, 'bf16', nbytes)
            layers = sum(1 for m in dcn if m.stride == stride
                         and m.weight.shape[0] == f)
            rows.append({'input': list(shape), 'stride': stride,
                         'out_channels': f, 'ms': t, 'bound_ms': bound_ms,
                         'bound_by': by, 'share': bound_ms / t,
                         'layers_of_this_kind': layers})
    print(f'[26b DCN shapes, {label}] '
          + json.dumps({'card': card, 'rows': rows}))
    return rows


# Phase 27: per sample of a b4 batch, the image rot-scale-flip's forced
# draws: (rotation in degrees, flip_dx, flip_dy) -- the rotation range's
# two ends, and each flip on and off.
AUG_DRAWS = ((22.5, 1.0, 0.0), (-22.5, 0.0, 1.0), (22.5, 1.0, 1.0),
             (-22.5, 0.0, 0.0))


def augment_batch(batch, rng):
    """A ``random_train_batch`` through the port's augmentation: each
    sample's images through ``photometric_distortion``, its GT, points and
    camera geometry through ``global_rot_scale_trans_image`` with the
    draws of ``AUG_DRAWS``, ``img2lidar`` recomputed in f64 as the
    dataset does."""
    from omnihd_scenes_tpu_torch.data import augmentation as A

    out = {k: v.copy() for k, v in batch.items()}
    for s in range(len(batch['imgs'])):
        img2lidar = np.tile(np.eye(4), (len(batch['imgs'][s]), 1, 1))
        img2lidar[:, :3, :3] = batch['img2lidar_rots'][s]
        img2lidar[:, :3, 3] = batch['img2lidar_trans'][s]
        l2i = np.linalg.inv(img2lidar).astype(np.float32)
        out['imgs'][s] = A.photometric_distortion(batch['imgs'][s], rng)
        rot, flip_dx, flip_dy = AUG_DRAWS[s % len(AUG_DRAWS)]
        boxes, l2i, pts, _ = A.global_rot_scale_trans_image(
            batch['gt_boxes'][s], l2i, rng, points=batch['points'][s],
            vel_dims=(3, 5), rot_range=(rot, rot), flip_dx_ratio=flip_dx,
            flip_dy_ratio=flip_dy)
        out['gt_boxes'][s], out['points'][s] = boxes, pts
        inv = np.linalg.inv(l2i.astype(np.float64))
        out['img2lidar_rots'][s] = inv[:, :3, :3]
        out['img2lidar_trans'][s] = inv[:, :3, 3]
    return out


def phase_aug_kernels(dev, batch):
    """(27) The LSS kernels on the augmented geometry of ``batch``: the
    fused kernel's dumped fields against the plain fields (phase 3's
    rule), its output against the plain gather, the backward against its
    plain version (phase 12's tolerance)."""
    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        cell_indices, gather_cells, geometry_fields, lss_sample_bev,
        lss_sample_bev_backward, lss_sample_bev_backward_reference)
    from omnihd_scenes_tpu_torch.ops.lss_project import (_Geom,
                                                         camera_geometry,
                                                         check_rotations)

    lss = BEVFusionConfig().lss
    nx, ny, nz = lss.bev_nx
    g = _Geom(lss.final_dim, lss.feat_hw, lss.camera_depth_range,
              lss.pc_range[:3], (lss.grid,) * 3, (nx, ny, nz))
    sx = lss.cam_solve_x
    rots, trans = (torch.from_numpy(batch[k]).to(dev)
                   for k in ('img2lidar_rots', 'img2lidar_trans'))
    check_rotations(rots.cpu())
    minv, mt = (t.contiguous() for t in camera_geometry(rots, trans))
    gen = torch.Generator(device=dev).manual_seed(27)
    b = len(rots)
    shape = (b, len(sx)) + tuple(lss.feat_hw)
    feat = torch.randn(shape + (lss.camC,), generator=gen,
                       device=dev).to(torch.bfloat16)
    depth = torch.softmax(torch.randn(shape + (lss.depth_bins,),
                                      generator=gen, device=dev),
                          -1).to(torch.bfloat16)
    out32, idx = lss_sample_bev(feat, depth, minv, mt, g, sx,
                                out_dtype=torch.float32, dump=True)
    out16 = lss_sample_bev(feat, depth, minv, mt, g, sx,
                           out_dtype=torch.bfloat16)
    want_idx = cell_indices(*geometry_fields(minv, mt, g, sx), sx, g.ny,
                            g.nx, lss.depth_bins)
    differ, total = _index_differences(idx, want_idx, '27 aug')
    per_sample = [sum(int((a[s] != w[s]).sum()) for a, w in zip(idx,
                                                                 want_idx))
                  for s in range(b)]
    ref = gather_cells(feat, depth, *(idx if differ else want_idx),
                       torch.float32)
    torch.cuda.synchronize()
    err, tol = _check_against(out32, out16, ref, 'fused kernel vs plain on '
                              'the augmented geometry')
    grad = torch.randn((b, g.ny, g.nx, g.nz, lss.camC), generator=gen,
                       device=dev).to(torch.bfloat16)
    args = (grad, feat, depth, minv, mt, g, sx)
    got = lss_sample_bev_backward(*args)
    want = lss_sample_bev_backward_reference(*args)
    rel = []
    for name, a, w in zip(('dfeat', 'ddepth'), got, want):
        check(a.dtype == w.dtype and _backward_tolerance(a, w),
              f'27 backward {name} off the plain version on the augmented '
              f'geometry')
        rel.append(float((a.float() - w.float()).abs().max())
                   / float(w.float().abs().max()))
    dets = np.linalg.det(batch['img2lidar_rots'].astype(np.float64))
    print(f'[27 aug kernels] b{b} bf16, draws (rot deg, flip_dx, flip_dy) '
          f'{list(AUG_DRAWS)[:b]}, det(img2lidar) signs per sample '
          f'{[int(np.sign(d).sum()) for d in dets]}: fused kernel indices '
          f'differing per sample {per_sample} of {total // b} entries each '
          f'(phase 3 rule); output max|d| {err:.3e} (tol {tol:.3e}), bf16 '
          f'within 1 ulp; backward dfeat {rel[0]:.3e}, ddepth {rel[1]:.3e} '
          f'of max|ref| (phase 12 tolerance)')
    del out32, out16, idx, want_idx, ref, got, want, feat, depth, grad
    torch.cuda.empty_cache()


def phase_aug_train(dev, card):
    """(27) Augmented BEVFusion training at full width; returns the LSS
    (backward, forward) launches of its steps."""
    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                         random_train_batch)

    cfg = BEVFusionConfig()
    rng = np.random.RandomState(270)
    t0 = time.perf_counter()
    probe = augment_batch(random_train_batch(rng, cfg, BATCH), rng)
    aug_s = time.perf_counter() - t0
    print(f'[27 aug] one b{BATCH} batch augmented on the host in '
          f'{aug_s:.2f} s (photometric jitter of 6 x 544x960 images and '
          f'the image rot-scale-flip per sample)')
    phase_aug_kernels(dev, probe)
    del probe
    sd = random_state_dict(cfg, seed=0)
    _, launches = phase_train(dev, card, BATCH, sd, label='27 aug train',
                              augment=lambda b: augment_batch(b, rng))
    del sd
    torch.cuda.empty_cache()
    return launches


DECODE_ROUNDS = 6


def phase_host_feed(dev, card):
    """(28) The host feed and staged weights (see the module docstring)."""
    import os
    import subprocess
    import sys
    import tempfile

    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.data import native
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.data.prefetch import prefetch
    from omnihd_scenes_tpu_torch.data.radar_loading import load_radar_sweep
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
    from omnihd_scenes_tpu_torch.train import ckpt_remap
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_datasets
    from omnihd_scenes_tpu_torch.train.loop import (batch_to, checkpoint_file,
                                                    create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)
    from omnihd_scenes_tpu_torch.train.torch_import import load_state_dict
    from omnihd_scenes_tpu_torch.weights import init_weights

    config = 'configs/pointpillars_radar.py'
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'synth')
        generate(root, 'v1.0-mini', SyntheticConfig(
            n_scenes=4, samples_per_scene=12, n_radar_points=1000),
            images=False)
        create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                               max_sweeps=0)
        opts = [f'dataroot={root}',
                f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
                f'data.val.ann_file={root}/synth_infos_temporal_val.pkl']
        cfg = Config.fromfile(config)
        # No shuffle and room for every point: the dataset draws nothing
        # from its rng, so pooled batches can be held to inline ones.
        cfg.merge_from_options(opts + ['data.train.point_shuffle=False'])
        train_ds, _ = build_datasets(cfg)
        bs = cfg.data.samples_per_device

        # Native vs NumPy radar decode, per sweep: the library's build
        # timed apart, one untimed pass of each (file cache), then
        # DECODE_ROUNDS timed passes of each, the order swapped each round.
        t0 = time.perf_counter()
        native.get_lib()
        build_s = time.perf_counter() - t0
        sweeps = [(key, sw) for info in train_ds.infos
                  for key, sws in info['radars'].items() for sw in sws]
        rows = {use_native: [load_radar_sweep(sw, key, use_native=use_native)
                             for key, sw in sweeps]
                for use_native in (True, False)}
        ms = {True: [], False: []}
        for r in range(DECODE_ROUNDS):
            for use_native in ((True, False) if r % 2 == 0
                               else (False, True)):
                t0 = time.perf_counter()
                for key, sw in sweeps:
                    load_radar_sweep(sw, key, use_native=use_native)
                ms[use_native].append((time.perf_counter() - t0) * 1e3
                                      / len(sweeps))
        worst = 0.0
        for a, b in zip(rows[True], rows[False]):
            worst = max(worst, float(np.abs(a - b).max())
                        / max(1.0, float(np.abs(b).max())))
        check(worst <= 1e-6, f'native radar rows off NumPy by {worst:.3e}')

        def epoch_rate(loader, feed=None, epochs=4):
            """Samples/s over epochs 1.. (epoch 0 warms the pool and the
            pinned allocator) and epoch 1's batches."""
            batches = []
            for epoch in range(epochs):
                if epoch == 1:
                    t0 = time.perf_counter()
                loader.set_epoch(epoch)
                it = iter(loader) if feed is None else feed(iter(loader))
                batches.append(list(it))
                if feed is not None:
                    torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            return (epochs - 1) * len(loader) * bs / seconds, batches[1]

        rates = {}
        inline = TrainLoader(train_ds, bs, seed=3)
        rates['inline'], want = epoch_rate(inline)
        for name, feed in (('2 workers', None), ('2 workers + pinned '
                                                 'prefetch', lambda it:
                                                 prefetch(it, device=dev))):
            loader = TrainLoader(train_ds, bs, seed=3, num_workers=2)
            try:
                rates[name], got = epoch_rate(loader, feed)
            finally:
                loader.close()
            for g, w in zip(got, want, strict=True):
                for k, v in w.items():
                    gv = g[k].cpu().numpy() if torch.is_tensor(g[k]) else g[k]
                    check(np.array_equal(gv, v), f'28 {name}: batch {k} '
                          f'differs from the inline loader')
        print(f'[28 host feed] {config} on a synthetic dataroot '
              f'({len(train_ds)} train samples, {len(sweeps)} radar sweeps, '
              f'b{bs}), os.cpu_count() {os.cpu_count()}: samples/s '
              + ', '.join(f'{k} {v:.2f}' for k, v in rates.items())
              + f' (epochs 2-4 of each); pooled batches bit-equal to '
              f'inline; radar decode ms per sweep, median of '
              f'{DECODE_ROUNDS} passes (order swapped each pass) native '
              f'{np.median(ms[True]):.3f} {[round(x, 3) for x in ms[True]]}, '
              f'NumPy {np.median(ms[False]):.3f} '
              f'{[round(x, 3) for x in ms[False]]}, rows within '
              f'{worst:.2e} of a row\'s max; the native library built in '
              f'{build_s:.2f} s, outside the timed passes ({card})')

        work = os.path.join(tmp, 'work')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'omnihd_scenes_tpu_torch.tools.train',
             config, '--work-dir', work, '--no-validate', '--cfg-options',
             *opts, 'total_epochs=1', 'data.workers_per_device=2',
             "data.train.aug={'rot_scale_flip': {}}"],
            capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f'tools.train exited {proc.returncode}: '
              f'{proc.stderr[-2000:]}')
        with open(os.path.join(work, 'train.log.json')) as f:
            records = [json.loads(line) for line in f]
        losses = [r['loss'] for r in records if r['mode'] == 'train']
        check(losses and all(np.isfinite(losses)), f'losses {losses}')
        print(f'[28 tools.train] {config}, 2 workers, aug rot_scale_flip: '
              f'exit 0 in {seconds:.1f} s (whole process), losses {losses}')

        source = load_state_dict(checkpoint_file(os.path.join(work,
                                                              'ckpts')))
    bcfg = BEVFusionConfig()
    model = BEVFusion(bcfg)
    init_weights(model, torch.Generator().manual_seed(28))
    model.to(dev)
    merged, rep = ckpt_remap.load_pts_from(dict(model.named_parameters()),
                                           source, verbose=False)
    with torch.no_grad():
        for k in rep['loaded']:
            model.get_parameter(k).copy_(merged[k])
    check(all(torch.equal(model.get_parameter(k), source[k].to(dev))
              for k in rep['loaded']), 'a loaded tensor differs on the card')
    check(len(rep['loaded']) > 0, 'load_pts_from loaded nothing')
    model.to(memory_format=torch.channels_last)
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(2e-4, 1000, warmup_iters=0)))
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        model, 'bevfusion', bcfg.pillars.anchors(),
        camera_depth_range=bcfg.lss.camera_depth_range)))
    batch = batch_to(random_train_batch(np.random.RandomState(28), bcfg,
                                        BATCH), dev)
    _, loss, _ = step(state, batch)
    loss = float(loss)
    check(np.isfinite(loss), f'step after load_pts_from: loss {loss}')
    print(f'[28 load_pts_from] its checkpoint into configs/bevfusion.py\'s '
          f'model on the card: {len(rep["loaded"])} tensors loaded, each '
          f'equal on the card; {len(rep["skipped"])} skipped, '
          f'{len(rep["mismatched"])} mismatched, {len(rep["missing"])} left '
          f'at init; one b{BATCH} bf16-policy step: loss {loss:.4f}')
    del state, step, model, batch
    torch.cuda.empty_cache()


def _scatter_config(cfg):
    import dataclasses

    return dataclasses.replace(cfg, lss=dataclasses.replace(
        cfg.lss, splat_mode='scatter'))


def phase_scatter_small(dev):
    """29a: the scatter splat at a small size, f32, the card against the
    CPU (TF32 off): network outputs within 1e-4 of max|ref|; the card's
    ``index_add_`` adds with atomics, so two runs on it are compared and
    their difference printed."""
    import torch

    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    cfg = _scatter_config(_small_config())
    sd = random_state_dict(cfg, seed=29)
    req = random_request(np.random.RandomState(29), cfg, batch=2)
    gpu = Predictor(cfg, sd, device=dev, dtype=torch.float32)
    runs = [{k: v.cpu() for k, v in gpu.forward(*req).items()}
            for _ in range(2)]
    want = Predictor(cfg, sd, device='cpu', dtype=torch.float32).forward(
        *req)
    rel = {k: float((runs[0][k] - want[k]).abs().max()
                    / want[k].abs().max())
           for k in ('bev', 'cls_score', 'bbox_pred', 'dir_pred')}
    twice = max(float((runs[0][k] - runs[1][k]).abs().max()) for k in rel)
    print(f'[29 scatter small] GPU f32 vs CPU f32 network outputs off by '
          + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|ref| (limit 1e-4); two runs on the card differ by '
          f'{twice:.3e} at most')
    check(all(v <= 1e-4 for v in rel.values()),
          f'scatter GPU vs CPU: {rel}')


def phase_scatter(dev, card, cfg, state_dict, sample_ms):
    """29b: the scatter splat (``splat_mode='scatter'``) serving at full
    width, b4 bf16 on the serving weights: 1 + N_TIMED requests (ms,
    peak GiB, B splats and no LSS kernel launch per request); the view
    transform alone on a request's depth and features (frustum ids +
    ``lss_splat``) against its bound and against the sampling kernel on
    the same inputs (different functions: the share is printed, not
    checked), and the difference between two runs (atomics)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                            lss_sample_bev)
    from omnihd_scenes_tpu_torch.ops.bev_pool import lss_splat
    from omnihd_scenes_tpu_torch.ops.lss_project import lss_sample_bev as \
        sample_view
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from omnihd_scenes_tpu_torch.tools.roofline import bound, splat_cost

    cfg = _scatter_config(cfg)
    predictor = Predictor(cfg, state_dict, device=dev, dtype=torch.bfloat16)
    lss = predictor.model.lss
    captured = []
    splat = lss.scatter

    def capture(*args):
        captured[:] = [args]
        return splat(*args)

    lss.scatter = capture
    rng = np.random.RandomState(29)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    lss_sample_bev.launches = lss_sample.launches = 0
    lss_splat.calls = 0
    dev_ms = []
    for req in requests:
        start.record()
        boxes, scores, labels, valid = predictor(*req)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        check(tuple(boxes.shape) == (BATCH, 500, 9)
              and bool(torch.isfinite(boxes).all()), 'scatter serving')
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = lss_sample_bev.launches
    check(launches == 0 and lss_sample.launches == 0,
          f'the scatter path launched the LSS kernel {launches} times')
    check(lss_splat.calls == BATCH * len(requests),
          f'{lss_splat.calls} splats for {len(requests)} b{BATCH} requests')
    lss.scatter = splat
    ms = float(np.mean(dev_ms[1:]))

    depth, feat, rots, trans = captured[0]
    with torch.inference_mode():
        one = splat(depth, feat, rots, trans)
        two = splat(depth, feat, rots, trans)
        t_splat = cuda_ms(lambda: splat(depth, feat, rots, trans), 5, 2)
        nx, ny, nz = cfg.lss.bev_nx
        solve_x = (cfg.lss.cam_solve_x + (True,) * 6)[:6]

        def sample():
            return sample_view(
                depth, feat, rots, trans, image_size=cfg.lss.final_dim,
                depth_range=cfg.lss.camera_depth_range,
                bev_start=cfg.lss.pc_range[:3], bev_voxel=(cfg.lss.grid,) * 3,
                bev_nx=(nx, ny, nz), solve_x=solve_x)

        t_sample = cuda_ms(sample, 10, 2)
        from omnihd_scenes_tpu_torch.ops.bev_pool import frustum_voxel_ids

        frustum = torch.from_numpy(cfg.lss.frustum()).to(dev)

        def ids():
            return [frustum_voxel_ids(
                frustum, rots[b], trans[b], cfg.lss.pc_range[:3],
                (cfg.lss.grid,) * 3, (nx, ny, nz)) for b in range(BATCH)]

        in_range = sum(int((i < nx * ny * nz).sum()) for i in ids())
        t_ids = cuda_ms(ids, 5, 1)
    twice = float((one.float() - two.float()).abs().max())
    ops, nbytes = splat_cost(depth.numel(), feat.numel(), in_range,
                             feat.shape[-1], one.numel(), 2, 2)
    b_ms, by = bound(ops, 'f32', nbytes)
    print(f'[29 scatter serving] b{BATCH} bf16 x {N_TIMED} requests (+1 '
          f'warm-up): {ms:.2f} ms/request by CUDA events ({dev_ms[1:]}), '
          f'{BATCH * 1e3 / ms:.3f} samples/s, {ms - sample_ms:+.2f} ms '
          f'against phase 5\'s sampling request; peak {peak:.2f} GiB '
          f'allocated ({card}); {lss_splat.calls} splats, LSS kernel '
          f'launches 0')
    print(f'[29 scatter splat] b{BATCH} view transform (frustum ids + '
          f'lss_splat, {in_range} of {BATCH * depth[0].numel()} frustum '
          f'points in the grid): {t_splat:.4f} ms (the ids {t_ids:.4f} ms '
          f'of it) against its bound '
          f'{b_ms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB; share '
          f'{b_ms / t_splat:.4f}); the sampling kernel on the same inputs '
          f'{t_sample:.4f} ms (scatter / sample {t_splat / t_sample:.2f}, '
          f'different functions, not checked); two scatter runs differ by '
          f'{twice:.3e} (max|out| {float(one.float().abs().max()):.3e})')
    del predictor, captured, one, two
    torch.cuda.empty_cache()
    return dict(request=launches, ms=ms, splat_ms=t_splat, bound_ms=b_ms,
                sample_ms=t_sample)


def phase_dense_fold(dev, card, cfg, state_dict):
    """30: ``pillar_impl='dense_fold'`` against ``'dense'`` serving, b4
    bf16 on the same weights, the two predictors alternating over 1 +
    N_TIMED fresh requests: ms of each, the pillar canvas and head maps
    of the last request compared (the fold is exact up to
    reassociation; bf16 rounds the two differently: within HEAD_TOL of
    max|dense|), one LSS launch per request on the fold path."""
    import dataclasses

    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    fold_cfg = dataclasses.replace(cfg, pillars=dataclasses.replace(
        cfg.pillars, pillar_impl='dense_fold'))
    predictors = {'dense': Predictor(cfg, state_dict, device=dev,
                                     dtype=torch.bfloat16),
                  'dense_fold': Predictor(fold_cfg, state_dict, device=dev,
                                          dtype=torch.bfloat16)}
    rng = np.random.RandomState(30)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev_ms = {k: [] for k in predictors}
    fold_counts = []
    for req in requests:
        for name, p in predictors.items():
            before = lss_sample_bev.launches
            start.record()
            boxes = p(*req)[0]
            end.record()
            torch.cuda.synchronize()
            dev_ms[name].append(start.elapsed_time(end))
            check(bool(torch.isfinite(boxes).all()), f'{name} boxes')
            if name == 'dense_fold':
                fold_counts.append(lss_sample_bev.launches - before)
    check(fold_counts == [1] * len(requests),
          f'lss_sample_bev launches per dense_fold request {fold_counts}')
    points, mask = (torch.from_numpy(a).to(dev) for a in requests[-1][:2])
    with torch.inference_mode():
        canvas = {k: p.model.pillar_canvas(points, mask).float()
                  for k, p in predictors.items()}
        maps = {k: p.forward(*requests[-1]) for k, p in predictors.items()}
    rel = {'canvas': float((canvas['dense_fold'] - canvas['dense']).abs()
                           .max() / canvas['dense'].abs().max())}
    for k in ('bev', 'cls_score'):
        d, f = maps['dense'][k].float(), maps['dense_fold'][k].float()
        rel[k] = float((f - d).abs().max() / d.abs().max())
    ms = {k: float(np.mean(v[1:])) for k, v in dev_ms.items()}
    print(f'[30 dense_fold] b{BATCH} bf16 x {N_TIMED} requests (+1 warm-up) '
          f'each, alternating on the same weights: dense {ms["dense"]:.2f} '
          f'ms ({dev_ms["dense"][1:]}), dense_fold {ms["dense_fold"]:.2f} ms '
          f'({dev_ms["dense_fold"][1:]}) ({card}); dense_fold against dense: '
          + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|dense| (limit {HEAD_TOL}); lss_sample_bev launches per '
          f'dense_fold request {fold_counts}')
    check(all(v <= HEAD_TOL for v in rel.values()),
          f'dense_fold off the dense path: {rel}')
    del predictors, canvas, maps
    torch.cuda.empty_cache()
    return fold_counts[0]


def phase_s2d(dev, card, cfg, state_dict, bf16_ms):
    """31: the space-to-depth stem (``stem_s2d``, ``bench.py --s2d``), b4
    bf16 on the serving weights with images packed on the host: 1 +
    N_TIMED requests (ms, peak GiB, one LSS launch each); the head maps
    against the standard stem's on the same unpacked request (the same
    function: within HEAD_TOL of max|ref|, bf16 rounding); then int8 +
    s2d: calibrate on a packed request (the stem records act_amax and
    stays float, as in JAX: no w8 for it), 1 + N_TIMED int8 requests with
    qconv launched once per eligible layer each."""
    import dataclasses

    import torch

    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.models.resnet import space_to_depth_np
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    s2d_cfg = dataclasses.replace(cfg, stem_s2d=True)
    rng = np.random.RandomState(31)
    requests = [random_request(rng, s2d_cfg, BATCH)
                for _ in range(1 + N_TIMED)]
    check(requests[0][2].shape[-1] == 12, 'requests not packed')
    predictor = Predictor(s2d_cfg, state_dict, device=dev,
                          dtype=torch.bfloat16)
    dev_ms, counts, peak, _ = _timed_requests(dev, predictor, requests)
    plain = random_request(rng, cfg, BATCH)
    packed = (*plain[:2], space_to_depth_np(plain[2]), *plain[3:])
    standard = Predictor(cfg, state_dict, device=dev, dtype=torch.bfloat16)
    keys = ('bev', 'cls_score', 'bbox_pred', 'dir_pred')
    got, want = predictor.forward(*packed), standard.forward(*plain)
    rel = {k: float((got[k].float() - want[k].float()).abs().max()
                    / want[k].float().abs().max()) for k in keys}
    del standard
    ms = float(np.mean(dev_ms))
    print(f'[31 s2d serving] b{BATCH} bf16 x {N_TIMED} requests (+1 '
          f'warm-up), packed (B, 6, 272, 480, 12) images: {ms:.2f} '
          f'ms/request by CUDA events ({dev_ms}), {ms - bf16_ms:+.2f} ms '
          f'against phase 5\'s standard stem, peak {peak:.2f} GiB allocated '
          f'({card}); against the standard stem on the unpacked request: '
          + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
          + f' of max|ref| (limit {HEAD_TOL}); lss_sample_bev launches '
          f'after each request {counts}')
    check(all(v <= HEAD_TOL for v in rel.values()),
          f's2d stem off the standard one: {rel}')
    del predictor
    torch.backends.cudnn.allow_tf32 = True
    try:
        quant = calibrate(s2d_cfg, state_dict, [packed], device=dev,
                          dtype=torch.bfloat16)
        check('resnet.conv1.act_amax' in quant
              and 'resnet.conv1.w8' not in quant,
              'the s2d stem must record act_amax and stay float')
        int8 = Predictor(s2d_cfg, state_dict, device=dev,
                         dtype=torch.bfloat16, quant_state=quant)
        eligible = _eligible_layers(int8.model)
        qconv3x3.launches = 0
        int8_ms, int8_counts, int8_peak, outs = _timed_requests(
            dev, int8, requests)
        q = qconv3x3.launches
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check(q == eligible * len(requests) and eligible > 0,
          f'int8 + s2d qconv launches {q} != {eligible} x {len(requests)}')
    check(all(bool(torch.isfinite(o[0]).all()) for o in outs),
          'int8 + s2d boxes')
    ms8 = float(np.mean(int8_ms))
    print(f'[31 int8 + s2d] b{BATCH} x {N_TIMED} requests (+1 warm-up): '
          f'{ms8:.2f} ms/request ({int8_ms}), peak {int8_peak:.2f} GiB; '
          f'{len(quant)} quant tensors, the stem act_amax only; qconv '
          f'launches {q} = {eligible} eligible layers x {len(requests)}; '
          f'lss_sample_bev launches after each request {int8_counts}')
    del int8, outs
    torch.cuda.empty_cache()
    return dict(request_b4=counts[0], int8_request_b4=int8_counts[0],
                qconv_int8_request_b4=q // len(requests))


def _first_step(dev, cfg, sd, batch, lr, policy=True):
    """One train step (under the bf16 policy, or in f32) from ``sd`` on a
    fresh state: (loss, {param: grad on the CPU}, {running stat: value on
    the CPU}, device ms, peak GiB, (LSS forward, backward) launches)."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import make_train_step

    state = _train_state(cfg, sd, dev, lr)
    loss_fn = make_loss_fn_generic(
        state.model, 'bevfusion', cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range)
    step = make_train_step(bf16_policy(loss_fn) if policy else loss_fn)
    grads = {}
    hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
             for k, p in state.model.named_parameters()]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    start.record()
    _, loss, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    out = (float(loss), {k: g.float().cpu() for k, g in grads.items()},
           {k: v.cpu() for k, v in state.model.named_buffers()
            if 'running' in k}, start.elapsed_time(end),
           torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           (lss_sample_bev.launches - launches[0],
            lss_sample_bev_backward.launches - launches[1]))
    del state, step, grads
    torch.cuda.empty_cache()
    return out


def phase_remat(dev, card, sd):
    """32: remat on ``configs/bevfusion.py``'s model, one batch and the
    same seeded weights.  b4 under the bf16 policy: first steps from fresh
    states in the order plain, remat, plain, remat (cold steps: ms and
    peak GiB printed), the remat step's running statistics within the
    larger of 4x the two plain runs' difference (run-to-run rounding) and
    1e-3 of the step's own update, so that a second update on
    recomputation (about the size of the update) fails; the LSS forward
    kernel runs twice a remat step (forward and recomputation), the
    backward once.  b2 in f32, TF32 off (two plain bf16 steps differ by up
    to ~1e-1 of a leaf's max on an H100): the remat step's
    gradients within GRAD_SHARE of each leaf's max|plain| (phase 25a's
    bound), beside the two plain f32 runs' own difference.  Then warm
    timed steps at b4 and b8 with remat (``phase_train``), the b4 one
    with one more step through ``run_training`` under
    ``set_sync_debug_mode``: one host sync, the logger's."""
    import dataclasses

    import torch

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
    from omnihd_scenes_tpu_torch.train.loop import batch_to

    plain_cfg = BEVFusionConfig()
    remat_cfg = dataclasses.replace(plain_cfg, remat=True)
    batch = batch_to(random_train_batch(np.random.RandomState(32), plain_cfg,
                                        BATCH), dev)
    runs = [_first_step(dev, cfg, sd, batch, 2e-4)
            for cfg in (plain_cfg, remat_cfg, plain_cfg, remat_cfg)]
    plain, remat = runs[0], runs[1]
    old = {k: v for k, v in sd.items() if k in plain[2]}
    floor = max(float((runs[2][2][k] - v).abs().max())
                for k, v in plain[2].items())
    update = max(float((v - old[k]).abs().max()) for k, v in plain[2].items())
    diff = max(float((remat[2][k] - v).abs().max())
               for k, v in plain[2].items())
    limit = max(4 * floor, 1e-3 * update)
    print(f'[32 remat] configs/bevfusion.py b{BATCH} bf16 policy, cold '
          f'first steps plain / remat / plain / remat: '
          + ', '.join(f'{r[3]:.2f} ms {r[4]:.2f} GiB' for r in runs)
          + f' ({card}); losses {[round(r[0], 4) for r in runs]}; running '
          f'statistics: remat - plain {diff:.3e}, plain - plain '
          f'{floor:.3e}, the update itself {update:.3e} (limit '
          f'{limit:.3e}); (LSS forward, backward) launches plain '
          f'{plain[5]}, remat {remat[5]}')
    check(plain[5] == (1, 1) and remat[5] == (2, 1),
          f'LSS launches plain {plain[5]}, remat {remat[5]}')
    check(limit < 0.1 * update and diff <= limit,
          f'remat running statistics off by {diff} (limit {limit}, update '
          f'{update})')
    check(abs(remat[0] - plain[0]) <= 1e-3 * abs(plain[0]),
          f'remat loss {remat[0]} against {plain[0]}')
    del runs, plain, remat

    small = {k: v[:2] for k, v in batch.items()}
    f32 = [_first_step(dev, cfg, sd, small, 2e-4, policy=False)
           for cfg in (plain_cfg, remat_cfg, plain_cfg)]

    def leaf_gap(a, b):
        return {k: float((a[1][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for k, g in b[1].items()}

    gap, grad_floor = leaf_gap(f32[1], f32[0]), leaf_gap(f32[2], f32[0])
    worst = sorted(gap.items(), key=lambda kv: -kv[1])[:3]
    print(f'[32 remat] b2 f32 first steps plain / remat / plain: '
          + ', '.join(f'{r[3]:.2f} ms {r[4]:.2f} GiB' for r in f32)
          + f'; losses {[r[0] for r in f32]}; remat gradients within '
          f'{worst[0][1]:.3e} of each leaf\'s max|plain| (limit '
          f'{GRAD_SHARE}; worst {worst}), plain - plain '
          f'{max(grad_floor.values()):.3e}')
    check(worst[0][1] <= GRAD_SHARE, f'remat f32 gradients off: {worst}')
    del f32
    b4_ms, (b4_back, b4_fwd) = phase_train(
        dev, card, BATCH, sd, cfg=remat_cfg, label='32 remat train step',
        per_step=(2, 1), sync_check=True)
    b8_ms, _ = phase_train(dev, card, 8, sd, cfg=remat_cfg,
                           label='32 remat train step', per_step=(2, 1),
                           timed=2)
    torch.cuda.empty_cache()
    return dict(train_fwd=b4_fwd, train_back=b4_back, b4_ms=b4_ms,
                b8_ms=b8_ms)


def phase_mtl_int8(dev, card):
    """33: BEVFusion-OCC's int8 tier (``bench.py --mtl --int8``): the
    serving configuration inside ``MTLConfig``, calibrate + freeze on one
    fresh b4 request in bf16 (no quant state for the occupancy head, whose
    convs are plain in JAX), 1 + N_TIMED int8 requests (ms, qconv once
    per eligible layer and the LSS kernel once per request, the occupancy
    argmax on the card), then phase 11's checks against the bf16
    predictor on the last request, and the share of voxels whose argmax
    agrees (printed)."""
    import torch

    from omnihd_scenes_tpu_torch.config import MTLConfig, serving_config
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)

    cfg = MTLConfig(fusion=serving_config())
    sd = random_state_dict(cfg, seed=0)
    rng = np.random.RandomState(33)
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        quant = calibrate(cfg, sd, [random_request(rng, cfg, BATCH)],
                          device=dev, dtype=torch.bfloat16)
        calib_s = time.perf_counter() - t0
        check(not [k for k in quant if k.startswith('occ_head.')],
              'the occupancy head got quant state')
        int8 = Predictor(cfg, sd, device=dev, dtype=torch.bfloat16,
                         quant_state=quant)
        eligible = _eligible_layers(int8.model)
        requests = [random_request(rng, cfg, BATCH)
                    for _ in range(1 + N_TIMED)]
        qconv3x3.launches = 0
        dev_ms, counts, peak, outs = _timed_requests(dev, int8, requests)
        q = qconv3x3.launches
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check(q == eligible * len(requests) and eligible > 0,
          f'MTL int8 qconv launches {q} != {eligible} x {len(requests)}')
    nx, ny, _ = cfg.fusion.lss.bev_nx
    for out in outs:
        check(bool(torch.isfinite(out[0]).all())
              and tuple(out[4].shape) == (BATCH, nx, ny, cfg.occ_dz)
              and out[4].is_cuda, 'MTL int8 outputs')
    ms = float(np.mean(dev_ms))
    print(f'[33 MTL int8] BEVFusion-OCC b{BATCH} x {N_TIMED} int8 requests '
          f'(+1 warm-up): {ms:.2f} ms/request by CUDA events ({dev_ms}), '
          f'{BATCH * 1e3 / ms:.3f} samples/s, peak {peak:.2f} GiB ({card}); '
          f'calibrate + freeze {calib_s:.2f} s, {len(quant)} quant tensors; '
          f'qconv launches {q} = {eligible} eligible layers x '
          f'{len(requests)}; lss_sample_bev launches after each request '
          f'{counts}')
    bf16 = Predictor(cfg, sd, device=dev, dtype=torch.bfloat16)
    phase_int8_vs_bf16(bf16, int8, requests[-1], label='33 MTL int8 vs bf16')
    agree = float((bf16(*requests[-1])[4] == outs[-1][4]).float().mean())
    print(f'[33 MTL int8 vs bf16] occupancy argmax equal on {agree:.4f} of '
          f'the voxels (random weights; printed, not checked)')
    del int8, bf16, outs
    torch.cuda.empty_cache()
    return dict(request=counts[0], qconv_request=q // len(requests))


# Phase 34: camera dataroots on the card.
CAMERA_SYNTH = dict(n_scenes=2, samples_per_scene=4, image_hw=(1080, 1920),
                    cam_distortion=(-0.05, 0.01, 1e-3, -1e-3, 0.0))
CAMERA_CONFIGS = ('configs/lss_camera.py', 'configs/rcfusion.py',
                  'configs/bevfusion_occ.py', 'configs/bevformer_t_r50.py')
BEVFUSION_CONFIG = 'configs/bevfusion.py'
BENCH_SAMPLES = 24
JPEG_FIXTURES = 'tests/torch_port_fixtures/jpeg/'
JPEG_FIXTURE_NAMES = ('camera_1080p_420', 'noise_64x96_420',
                      'noise_64x96_444')
# 34d: candidate pairs whose f64 IoU lies this close to the threshold may
# go either way between the native core and the vectorised reference.
HOST_IOU_TIE = 1e-9


@contextlib.contextmanager
def _blocked_modules(*names):
    """Make ``import name`` fail for each name while the block runs."""
    import sys

    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _camera_options(root, batch):
    return [f'dataroot={root}', 'version=v1.0-mini', 'eval_set=val_mini',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl',
            f'data.samples_per_device={batch}']


def _seeded_checkpoint(path, opts, ckpt_dir):
    """``path``'s model with the seeded weights of ``init_model`` (seed 0,
    as ``serve/synthetic.py`` draws them), saved as a ``tools.train``
    checkpoint in ``ckpt_dir`` -> (cfg, model on the CPU, model type)."""
    import torch

    from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                       init_model)
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    save_checkpoint)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    cfg = Config.fromfile(path)
    cfg.merge_from_options(opts)
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    save_checkpoint(ckpt_dir, create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(1e-3, 100, warmup_iters=10))), 1)
    return cfg, model, mtype


def _cli(module, *args, timeout=600):
    """Run ``python -m module args`` -> (stdout, seconds); raises on a
    non-zero exit."""
    import sys

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', module, *args],
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f'{module} {args[0]} exited '
          f'{proc.returncode}: {proc.stderr[-3000:]}')
    return proc.stdout, seconds


def _printed_launches(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith('kernel launches ')]
    check(len(lines) == 1, 'tools.test printed no kernel launch line')
    return json.loads(lines[0][len('kernel launches '):])


def _finite_metrics(out_dir, label):
    with open(f'{out_dir}/metrics.json') as f:
        m = json.load(f)
    check(np.isfinite(m['mAP']) and np.isfinite(m['NOS']),
          f'{label} metrics {m}')
    return m


def _kept_rows(out_dir):
    """Each sample's kept boxes of a results JSON, as a multiset."""
    import collections

    with open(f'{out_dir}/results_newsc.json') as f:
        results = json.load(f)['results']
    return {tok: collections.Counter(json.dumps(r, sort_keys=True)
                                     for r in rows)
            for tok, rows in results.items()}


def _fixture_exact(dev):
    """34a: the card's decode of the committed JPEG fixtures against their
    cv2.imdecode result: every value equal (max |d| 0) -> that max."""
    from omnihd_scenes_tpu_torch.data.jpeg import decode_jpegs

    blobs = [np.fromfile(f'{JPEG_FIXTURES}{n}.jpg', np.uint8)
             for n in JPEG_FIXTURE_NAMES]
    top = 0
    for n, img in zip(JPEG_FIXTURE_NAMES, decode_jpegs(blobs, dev)):
        ref = np.load(f'{JPEG_FIXTURES}{n}.npz')['bgr'].astype(int)
        d = np.abs(img.cpu().numpy().astype(int) - ref)
        print(f'[34a JPEG fixtures] {n}: max |d| {int(d.max())}, '
              f'{int((d > 0).sum())} of {d.size} values differ from '
              'cv2.imdecode')
        check(d.max() == 0, f'card decode of {n} differs from cv2.imdecode')
        top = max(top, int(d.max()))
    return top


def _sample_grid(images, maps, out_hws, target):
    """F.grid_sample's grid (N, th, tw, 2) of the batch's own rectify
    chain: each output pixel's centre scaled (half-pixel centres, as both
    resizes) to the undistorted image, then that image's map entry at the
    nearest pixel, normalised to the decoded image (align_corners=False);
    the pad lies off the image (zeros)."""
    import torch

    grids = []
    th, tw = target
    for img, m, (oh, ow) in zip(images, maps, out_hws):
        h, w = img.shape[:2]
        dev = img.device
        ys = torch.arange(th, device=dev, dtype=torch.float64)
        xs = torch.arange(tw, device=dev, dtype=torch.float64)
        yf = (ys + 0.5) * (h / oh) - 0.5
        xf = (xs + 0.5) * (w / ow) - 0.5
        yi = yf.round().clamp(0, h - 1).long()
        xi = xf.round().clamp(0, w - 1).long()
        src = m[yi[:, None], xi[None, :]].double() / 32      # (th, tw, 2)
        g = torch.stack([(src[..., 0] + 0.5) / w, (src[..., 1] + 0.5) / h],
                        -1) * 2 - 1
        inside = (ys < oh)[:, None, None] & (xs < ow)[None, :, None]
        grids.append(torch.where(inside, g, -2.0).float())
    return torch.stack(grids)


def _cpu_model():
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return 'unknown CPU'


def _decode_on_batch(dev, card, batch):
    """34b: one b4 batch of the dataroot (24 images), stage by stage: the
    host entropy decode on 1 thread and on the default count, the pinned
    upload of its coefficients, the IDCT kernel against its plain version
    on the card (bit-equal; no library call computes islow; its SASS
    instructions a block and their issue floor; nvJPEG's batched decode
    of the same JPEGs timed as the decode's yardstick), the fused rectify
    kernel against its plain version on the card (bit-equal; library: one
    F.grid_sample of the decoded f32 images on the chain's own grid) ->
    the rectify and IDCT rows of the kernels line (max |d|, ms, plain ms,
    bound ms, bound_by, library ms) and the IDCT row's further keys (the
    host stages, nvJPEG, the SASS count)."""
    import os

    import torch
    import torch.nn.functional as F

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data import jpeg as J
    from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.tools.roofline import HBM_BYTES_PER_S

    offsets, data = batch[IL.JPEG_OFFSETS], batch[IL.JPEG_BYTES]
    blobs = [data[offsets[i, c]:offsets[i, c + 1]]
             for i in range(offsets.shape[0])
             for c in range(offsets.shape[1] - 1)]
    jpeg_bytes = sum(int(b.size) for b in blobs)

    pin = dev.type == 'cuda'

    def host_ms(threads, reps=3):
        J.entropy_decode(blobs, pin=pin, threads=threads)       # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = J.entropy_decode(blobs, pin=pin, threads=threads)
        return (time.perf_counter() - t0) / reps * 1e3, out

    threads = min(len(blobs), os.cpu_count() or 1)
    host1, _ = host_ms(1, 2)
    host_n, c = host_ms(threads)
    coef_bytes = int(c.coefs.numel()) * 2
    upload = cuda_ms(lambda: c.coefs.to(dev, non_blocking=True), 10, 2)
    print(f'[34b host decode] {len(blobs)} JPEGs ({jpeg_bytes} bytes) -> '
          f'{coef_bytes / 1e6:.1f} MB of int16 coefficients: {host1:.3f} ms '
          f'on 1 thread ({host1 / len(blobs):.3f} ms an image), {host_n:.3f} '
          f'ms on {threads} threads; {os.cpu_count()} CPUs, {_cpu_model()}; '
          f'pinned upload {upload:.4f} ms ({coef_bytes / upload / 1e6:.1f} '
          f'GB/s; {card})')

    coefs = c.coefs.to(dev, non_blocking=True)
    quant = c.quant.to(dev, non_blocking=True)
    buf = JI.jpeg_idct(coefs, quant, c.comps)
    plain_buf = JI.jpeg_idct_plain(coefs, quant, c.comps)
    idct_err = float((buf.int() - plain_buf.int()).abs().max())
    check(idct_err == 0, f'jpeg_idct != plain (max |d| {idct_err})')
    idct_ms = kernel_ms(lambda: JI.jpeg_idct(coefs, quant, c.comps),
                        'jpeg_idct_kernel', 20, 3)
    idct_plain = cuda_ms(lambda: JI.jpeg_idct_plain(coefs, quant, c.comps),
                         2, 1)
    idct_bound = JI.jpeg_idct_bytes(coefs) / HBM_BYTES_PER_S * 1e3
    nv_ms = cuda_ms(lambda: J.nvjpeg_decode_planes(blobs, dev), 3, 1)
    n_blocks, n_chunks = coefs.numel() // 64, len(JI.idct_chunks(c.comps))
    sass = _idct_sass(n_blocks, n_chunks)
    # What the card's memory gives on the same bytes: one device copy that
    # reads and writes half of them each.
    src = torch.empty(JI.jpeg_idct_bytes(coefs) // 2, dtype=torch.uint8,
                      device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), 20, 3)
    del src, dst
    print(f'[34b jpeg_idct] {n_blocks} blocks in {n_chunks} chunks, one '
          f'launch: bit-equal to plain; {idct_ms:.4f} ms against '
          f'{idct_bound:.4f} ms (bytes, '
          f'{JI.jpeg_idct_bytes(coefs) / 1e6:.1f} MB; share '
          f'{idct_bound / idct_ms:.3f}), plain {idct_plain:.2f} ms; no '
          f'library call computes islow; nvJPEG\'s batched decode of the '
          f'same JPEGs (Huffman + its own IDCT) {nv_ms:.4f} ms; SASS: '
          f'{sass["sass_kernel"]} instructions in the kernel, '
          f'{sass["sass_block"]} a block (a lane\'s, first coefficient load '
          f'to last pixel store), {sass["warp_instructions_per_block"]:.2f} '
          f'warp instructions a block, issue floor '
          f'{sass["issue_floor_ms"]:.4f} ms at {sass["sm_clock_mhz"]} MHz x '
          f'{sass["sms"]} SMs x 4; a device copy of the same bytes '
          f'{copy_ms:.4f} ms ({card})')

    planes = J.planes_of(buf, c)
    got_planes, (maps, u8_hws, out_hws, target, mean, std, _) = \
        IL.decoded_sources(batch, dev)
    check(all(torch.equal(a, b) for p, q in zip(planes, got_planes)
              for a, b in zip(p[:3], q[:3])),
          'decoded_sources does not return the IDCT\'s planes')
    check(all(isinstance(m, R.DeviceMap) for m in maps),
          'phase 34 cameras undistort')
    args = (u8_hws, out_hws, target, mean, std)
    whole = R.rectify(planes, maps, *args)
    plain = R.rectify_plain(planes, maps, *args)
    err = float((whole - plain).abs().max())
    check(torch.equal(whole, plain), f'rectify != plain (max |d| {err})')

    def call():
        R.rectify(planes, maps, *args)

    ms = kernel_ms(call, 'rectify_kernel', 20, 3)
    call_ms = cuda_ms(call, 20, 3)
    plain_ms = cuda_ms(lambda: R.rectify_plain(planes, maps, *args), 2, 1)
    nbytes = R.rectify_bytes(planes, maps, target)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    images = R.planes_to_bgr(planes)
    x = torch.stack([i.permute(2, 0, 1).float() for i in images])
    grid = _sample_grid(images, [m.fixed for m in maps], out_hws, target)
    lib_ms = cuda_ms(lambda: F.grid_sample(x, grid, align_corners=False), 20,
                     3)
    fb = sum(tuple(hw) != tuple(p.y.shape) for p, hw in zip(planes, u8_hws))
    print(f'[34b rectify] b{offsets.shape[0]} ({len(planes)} x '
          f'{planes[0].y.shape[0]}x{planes[0].y.shape[1]} '
          f'4:2:0 planes -> {target}, {fb} halved), one launch: bit-equal '
          f'to plain; {ms:.4f} ms (kernel; the wrapper\'s call '
          f'{call_ms:.4f} ms) against {bound_ms:.4f} ms (bytes, '
          f'{nbytes / 1e6:.1f} MB; share {bound_ms / ms:.3f}), plain '
          f'{plain_ms:.2f} ms, F.grid_sample of the f32 images on the '
          f'chain\'s grid {lib_ms:.4f} ms ({card})')
    layouts, per_camera_bound = _rectify_layouts(dev, card, batch, planes,
                                                 maps, args, plain)
    setup = _rectify_setup(dev, card, planes, maps, args)
    host = dict(host_decode_ms_1_thread=host1, host_decode_ms=host_n,
                host_threads=threads, host_cpus=os.cpu_count(),
                host_cpu=_cpu_model(), upload_ms=upload,
                upload_bytes=coef_bytes, jpeg_bytes=jpeg_bytes,
                images=len(blobs), chunks=n_chunks, nvjpeg_decode_ms=nv_ms,
                copy_same_bytes_ms=copy_ms, **sass)
    return ((err, ms, plain_ms, bound_ms, 'bytes', lib_ms),
            (idct_err, idct_ms, idct_plain, idct_bound, 'bytes', None), host,
            dict(call_ms=call_ms, layout_ms=layouts,
                 bound_ms_per_camera_maps=per_camera_bound), setup)


def _idct_sass(n_blocks, n_chunks):
    """The IDCT kernel's SASS (``cuobjdump -sass`` of the built library):
    its instructions, those a lane runs for one block (the straight-line
    code from the first 16-byte shared load of a coefficient row to the
    last 8-byte pixel store, unrolled, one block a lane), the warp
    instructions a block that makes on this batch (a warp runs a chunk),
    and the issue floor they imply: warp instructions over 4 issue slots
    x the SMs x the SM clock ``nvidia-smi`` reads as its maximum."""
    import os
    import re

    import torch

    from omnihd_scenes_tpu_torch.kernels._build import (library_path,
                                                         nvcc_path)

    tool = os.path.join(os.path.dirname(nvcc_path()), 'cuobjdump')
    dump = subprocess.run([tool, '-sass', str(library_path('jpeg_idct'))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    section = next(sec for sec in re.split(r'\n\s*Function : ', dump)[1:]
                   if 'jpeg_idct_kernel' in sec.split('\n', 1)[0])
    code = [(int(a, 16), text.strip()) for a, text in re.findall(
        r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', section)]
    code = [(a, t) for a, t in code if not t.startswith('NOP')]

    def op(t):
        return re.sub(r'^@!?U?P[T0-9]+\s+', '', t).split(' ')[0]

    first = min(a for a, t in code if op(t) == 'LDS.128')
    last = max(a for a, t in code if op(t).startswith('STG.E.64'))
    block = sum(first <= a <= last for a, _ in code)
    mhz = int(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp = n_chunks * block
    return dict(sass_kernel=len(code), sass_block=block,
                warp_instructions_per_block=warp / n_blocks,
                sm_clock_mhz=mhz, sms=sms,
                issue_floor_ms=warp / (4 * sms * mhz * 1e6) * 1e3)


def _rectify_layouts(dev, card, batch, planes, maps, args, plain):
    """34b: the rectify kernel's tile layouts timed on the batch: the
    images of one geometry and map interleaved tile by tile (rectify's)
    or laid out image by image, on the batch's own maps (the synthetic rig
    gives its six cameras one calibration) and on six per-camera maps
    (each camera's focal length and centre moved, as a real rig's
    differ), each launch bit-equal to the plain version -> ({layout: ms},
    the bound with the per-camera maps)."""
    import torch

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data.undistort import rectify_map
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.tools.roofline import HBM_BYTES_PER_S

    k = IL._host_array(batch['cam_intrinsics']).reshape(-1, 3, 3)
    dist = IL._host_array(batch['cam_distortion']).reshape(-1, 5)
    n_cam = IL._host_array(batch[IL.JPEG_OFFSETS]).shape[1] - 1
    own = []
    for cam in range(n_cam):
        kc = np.array(k[cam], np.float64)
        kc[0, 0] *= 1 + 0.01 * (cam + 1)
        kc[1, 1] *= 1 + 0.01 * (cam + 1)
        kc[0, 2] += 2.0 * (cam + 1)
        fixed = rectify_map(kc, dist[cam], tuple(planes[cam].y.shape))
        own.append(R.DeviceMap(torch.from_numpy(fixed).to(dev)))
    per_camera = [own[j % n_cam] for j in range(len(planes))]
    per_camera_plain = R.rectify_plain(planes, per_camera, *args)
    layouts = {}
    for label, lay_maps, want in (('shared_map', maps, plain),
                             ('per_camera_maps', per_camera,
                              per_camera_plain)):
        for interleave in (True, False):
            name = f'{label}_' + ('interleaved' if interleave
                                  else 'by_image')
            got = R._launch(planes, lay_maps, *args, interleave=interleave)
            check(torch.equal(got, want), f'rectify ({name}) != plain')
            layouts[name] = kernel_ms(
                lambda: R._launch(planes, lay_maps, *args,
                                  interleave=interleave),
                'rectify_kernel', 20, 3)
    bound = R.rectify_bytes(planes, per_camera, args[2]) / \
        HBM_BYTES_PER_S * 1e3
    print(f'[34b rectify layouts] kernel ms, each launch bit-equal to '
          f'plain: ' + ', '.join(f'{k} {v:.4f}' for k, v in layouts.items())
          + f'; bound with {n_cam} per-camera maps {bound:.4f} ms ({card})')
    return layouts, bound


def _rectify_setup(dev, card, planes, maps, args):
    """34b: rectify's setup kernels on the batch's map and geometries,
    each table against its plain version on the card (bit-equal), the
    footprint and taps tables from one launch a (map, geometry), timed at
    the full-size cameras' geometry from a cold L2 -> their rows of the
    kernels line (max |d|, ms, plain ms, bound ms, bound_by, library ms):
    the footprint's and the taps' rows both carry that one launch's time,
    bound (both tables and the map entries read) and plain time."""
    import torch

    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.tools.roofline import HBM_BYTES_PER_S

    u8_hws, out_hws, target = args[:3]
    geos = [R._geometry(*p.y.shape, int(p.mode), tuple(u8), tuple(hw),
                        tuple(target))
            for p, u8, hw in zip(planes, u8_hws, out_hws)]
    full = next(j for j, p in enumerate(planes)
                if tuple(u8_hws[j]) == tuple(p.y.shape))
    geo, fixed = geos[full], maps[full].fixed

    def diff(a, b):
        return float((a.long() - b.long()).abs().max())

    distinct = {id(m): m.fixed for m in maps}.values()
    e_pack = max(diff(R.pack_map(f), R.pack_map_plain(f)) for f in distinct)
    pairs = {(id(m), g): (m.fixed, g) for m, g in zip(maps, geos)}.values()
    e_foot = e_taps = 0.0
    for f, g in pairs:
        before = R.geometry_tables.launches
        got = R.geometry_tables(f, g, target)
        check(R.geometry_tables.launches == before + 1,
              'geometry_tables made more than one launch')
        want = R.geometry_tables_plain(f, g, target)
        e_foot = max(e_foot, diff(got[0], want[0]))
        e_taps = max(e_taps, diff(got[1], want[1]), diff(got[2], want[2]))
    check(e_pack == e_foot == e_taps == 0,
          f'rectify setup kernels != plain (max |d| pack {e_pack}, '
          f'footprint {e_foot}, taps {e_taps})')
    table, *taps = R.geometry_tables(fixed, geo, target)
    read = torch.zeros(fixed.shape[:2], dtype=torch.bool)
    for a, b, c, d in table[0::2].tolist():
        read[a:b + 1, c:d + 1] = True
    tables_bytes = (int(read.sum()) * 8 + table.numel() * 4
                    + sum(t.numel() * 4 for t in taps))
    runs = {'rectify_pack_map': (lambda: R.pack_map(fixed),
                                 lambda: R.pack_map_plain(fixed),
                                 'pack_map_kernel',
                                 fixed.numel() * 4 + fixed.numel() * 2),
            'geometry_tables': (
                lambda: R.geometry_tables(fixed, geo, target),
                lambda: R.geometry_tables_plain(fixed, geo, target),
                'geometry_tables_kernel', tables_bytes)}
    # Each timed launch starts with its inputs out of the 50 MB L2, as at
    # a map's first use: a 256 MB buffer is written before it.
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cold(fn):
        def run():
            flush.zero_()
            fn()
        return run

    def emptied(fn):
        def run():
            flush.sum()
            fn()
        return run

    timed = {}
    for name, (fn, plain_fn, key, nbytes) in runs.items():
        t = kernel_ms(cold(fn), key, 20, 3)
        pt = cuda_ms(plain_fn, 2, 1)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        timed[name] = (t, pt, bt)
        # The cold L2 above holds the buffer's dirty lines, which the
        # launch's reads must write back; beside it, the same launch after
        # the buffer was read (clean lines) and warm.
        t_read, t_warm = (kernel_ms(emptied(fn), key, 20, 3),
                          kernel_ms(fn, key, 20, 3))
        print(f'[34b {name}] bit-equal to plain on the batch\'s '
              f'{len(distinct)} map(s) and {len(set(geos))} geometries'
              + ('' if name == 'rectify_pack_map' else
                 ' (footprint and taps tables, one launch a map geometry)')
              + f'; {t:.4f} ms a launch (cold L2) against {bt:.4f} ms '
              f'(bytes, {nbytes / 1e6:.3f} MB), {t_read:.4f} after a read '
              f'of 256 MB, {t_warm:.4f} warm; plain {pt:.2f} ms ({card})')
    return {'rectify_pack_map': (e_pack, *timed['rectify_pack_map'],
                                 'bytes', None),
            'rectify_footprint': (e_foot, *timed['geometry_tables'],
                                  'bytes', None),
            'rectify_taps': (e_taps, *timed['geometry_tables'], 'bytes',
                             None)}


def _host_syncs(fn):
    """Run ``fn`` under ``set_sync_debug_mode('warn')`` -> the (file, line)
    of each host sync it made."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
    return [(w.filename, w.lineno) for w in caught
            if 'called a synchronizing CUDA operation' in str(w.message)]


def _nms_agreement(model, mtype, batch, dev):
    """34d in-process, on one batch's top-nms_pre candidates: per sample,
    whether the in-graph NMS (its 48-step suppression fixpoint) has
    converged, whether a greedy pass over the card's own suppression
    matrix (its f32 IoU > thr) reproduces the in-graph rows exactly,
    whether the host NMS (native core, f64 IoU) keeps exactly the rows of
    a greedy pass over the vectorised f64 IoU matrix
    (``rotated_iou_matrix_plain``, on the card), how many pairs' f64 IoU
    lies within HOST_IOU_TIE of the threshold, and whether the host and
    in-graph rows are equal (they may differ where an f32 IoU lies within
    float tolerance of it, ``near_pairs_f32`` of 1e-4)."""
    import torch

    from omnihd_scenes_tpu_torch.config import DecodeCfg
    from omnihd_scenes_tpu_torch.data.image_loading import (
        decode_camera_batch)
    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_decode_candidates)
    from omnihd_scenes_tpu_torch.ops import nms as N
    from omnihd_scenes_tpu_torch.ops.boxes3d import rotated_iou_bev
    from omnihd_scenes_tpu_torch.ops.nms_host import (
        greedy_kept, nms_rotated_multiclass_host, rotated_iou_matrix_plain)
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       model_inputs)
    from omnihd_scenes_tpu_torch.train.loop import batch_to

    cfg = DecodeCfg()
    anchors = torch.from_numpy(np.asarray(anchors_for(model, mtype),
                                          np.float32)).to(dev)
    with torch.inference_mode():
        out = model(*model_inputs(batch_to(decode_camera_batch(batch, dev),
                                           dev), mtype))
        boxes, scores = anchor_head_decode_candidates(
            out['cls_score'].float(), out['bbox_pred'].float(),
            out['dir_pred'].float(), anchors, cfg)
        graph = N.multiclass_nms_rotated(boxes, scores, cfg.score_thr,
                                         cfg.nms_thr, cfg.max_num)
        iou = rotated_iou_bev(boxes, boxes)
        sup = iou > cfg.nms_thr
        cls_scores = scores.transpose(-1, -2)
        cand = cls_scores > cfg.score_thr
        prec = N._precedence(torch.where(cand, cls_scores, -torch.inf))
        alive = N._greedy_fixpoint(sup[..., None, :, :], prec, cand)
        again = cand & ~(sup[..., None, :, :] & prec
                         & alive[..., :, None]).any(dim=-2)
        converged = (again == alive).flatten(1).all(1).cpu().tolist()
        near = ((iou - cfg.nms_thr).abs() < 1e-4).flatten(1).sum(1).tolist()
        iou64 = [rotated_iou_matrix_plain(b) for b in boxes]
        near64 = [int(((m - cfg.nms_thr).abs() < HOST_IOU_TIE).sum())
                  for m in iou64]
        sup64 = [(m > cfg.nms_thr).cpu().numpy() for m in iou64]
    b_np, s_np, sup_np = (t.cpu().numpy() for t in (boxes, scores, sup))
    n = b_np.shape[1]
    rows = []
    for i in range(b_np.shape[0]):
        host = nms_rotated_multiclass_host(b_np[i], s_np[i], cfg.score_thr,
                                           cfg.nms_thr, cfg.max_num)
        g = [np.asarray(t[i].cpu()) for t in graph]

        def kept(o):
            return sorted((int(l), tuple(b.tolist()), float(s))
                          for b, s, l, v in zip(*o[:3], o[3]) if v)

        def as_rows(greedy):
            return sorted((cl, tuple(b_np[i][j].tolist()), sc)
                          for cl, j, sc in greedy)

        kg, kh = kept(g), kept(host)
        rows.append(dict(
            converged=bool(converged[i]),
            greedy_equal=kg == as_rows(greedy_kept(
                sup_np[i], s_np[i], cfg.score_thr, cfg.max_num)),
            host_exact=kh == as_rows(greedy_kept(
                sup64[i], s_np[i], cfg.score_thr, cfg.max_num)),
            near_pairs_f64=near64[i], host_equal=kg == kh, kept=len(kh),
            near_pairs_f32=int(near[i]), candidates=n))
    return rows


def _write_camera_dataroot(tmp):
    """Phase 34's synthetic dataroot (1080p JPEGs written by nvJPEG, lens
    distortion) and its infos under ``tmp`` -> its path."""
    import os

    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)

    root = os.path.join(tmp, 'synth')
    generate(root, 'v1.0-mini', SyntheticConfig(**CAMERA_SYNTH),
             images=True, image_device='cuda')
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def phase_decode_kernels(dev, card):
    """34b alone, for a short call: phase 34's dataroot, one b4 val batch
    of it and the decode's kernels on that batch (``_decode_on_batch``)
    -> its rows, as phase 34 takes them."""
    import tempfile

    from omnihd_scenes_tpu_torch.data.loader import EvalLoader
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single

    with _blocked_modules('cv2', 'PIL'), \
            tempfile.TemporaryDirectory() as tmp:
        cfg = Config.fromfile(BEVFUSION_CONFIG)
        cfg.merge_from_options(_camera_options(_write_camera_dataroot(tmp),
                                               BATCH))
        dataset = build_dataset_single(cfg.data.val, 'det',
                                       image_decode='device')
        batch, _ = next(iter(EvalLoader(dataset, BATCH)))
        return _decode_on_batch(dev, card, batch)


def phase_camera_dataroot(dev, card):
    """34: camera dataroots on the card, with cv2 and PIL blocked."""
    import math
    import os
    import tempfile

    import torch

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data.jpeg import (decode_jpeg_planes,
                                                   nvjpeg_decode_planes)
    from omnihd_scenes_tpu_torch.data.loader import EvalLoader
    from omnihd_scenes_tpu_torch.data.image_loading import (
        decode_camera_batch)
    from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       make_predict_fn_generic)
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.eval_runner import (
        detections_to_host, run_inference_generic)

    t_phase = time.perf_counter()
    with _blocked_modules('cv2', 'PIL'), \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = _write_camera_dataroot(tmp)
        gen_s = time.perf_counter() - t0
        jpeg_max = _fixture_exact(dev)

        opts = _camera_options(root, BATCH)
        ckpts = {p: os.path.join(tmp, os.path.basename(p)[:-3])
                 for p in (BEVFUSION_CONFIG,) + CAMERA_CONFIGS}
        t0 = time.perf_counter()
        cfg, model, mtype = _seeded_checkpoint(BEVFUSION_CONFIG, opts,
                                               ckpts[BEVFUSION_CONFIG])
        for path in CAMERA_CONFIGS:
            _seeded_checkpoint(path, _camera_options(root, 1), ckpts[path])
        ckpt_s = time.perf_counter() - t0
        dataset = build_dataset_single(cfg.data.val, 'det',
                                       image_decode='device')
        n_batches = math.ceil(len(dataset) / BATCH)
        batch, _ = next(iter(EvalLoader(dataset, BATCH)))
        rect_row, idct_row, host, rect_extra, setup_rows = _decode_on_batch(
            dev, card, batch)

        # The main path in this process: tools.test's inference over the
        # val set at b4 (decode + rectify + the model), the counts zeroed
        # just before and read just after; then one batch's host syncs,
        # in-graph and host NMS.
        model.to(dev)
        predict = make_predict_fn_generic(model, mtype,
                                          anchors_for(model, mtype))
        host_predict = make_predict_fn_generic(
            model, mtype, anchors_for(model, mtype), host_nms=True)
        for fn in (predict, host_predict):                      # warm
            run_inference_generic(fn, model, dataset, BATCH)
        # The run starts with no calibration on the card, as a tools.test
        # process does: its first batch makes each map's DeviceMap
        # (pack_map) and each geometry's tables (footprint, taps).
        IL._DEVICE_MAPS.clear()
        R._TABLES.clear()
        _zero_launches()
        decode_jpeg_planes.calls = nvjpeg_decode_planes.calls = 0
        run_inference_generic(predict, model, dataset, BATCH)
        launches = dict(_read_launches(),
                        jpeg_decode=decode_jpeg_planes.calls,
                        nvjpeg_decode=nvjpeg_decode_planes.calls)
        n_maps = len(IL._DEVICE_MAPS)
        n_tables = sum(len(m.tables) for m in IL._DEVICE_MAPS.values()) \
            + len(R._TABLES)
        check(launches['lss_sample'] == n_batches
              and launches['rectify'] == n_batches
              and launches['jpeg_idct'] == n_batches
              and launches['jpeg_decode'] == n_batches
              and launches['nvjpeg_decode'] == 0
              and launches['rectify_pack_map'] == n_maps >= 1
              and launches['rectify_footprint'] == n_tables >= 1
              and launches['rectify_taps'] == n_tables,
              f'main path launches {launches} for {n_batches} b{BATCH} '
              f'batches, {n_maps} maps and {n_tables} map geometries (LSS, '
              'decode, IDCT and rectify 1 a batch, pack_map 1 a map, '
              'footprint and taps 1 a map geometry, nvJPEG 0)')
        batch.pop('index', None)
        syncs = {}
        for label, fn in (('in-graph NMS', predict),
                          ('host NMS', host_predict)):
            syncs[label] = _host_syncs(lambda: detections_to_host(
                fn(model, decode_camera_batch(batch, dev))[0]))
        print(f'[34 main path] {len(dataset)} val samples, {n_batches} b{BATCH} '
              f'batches: launches {launches}; host syncs of one batch '
              + '; '.join(f'{k}: {len(v)} at {v}' for k, v in syncs.items()))
        check(len(syncs['in-graph NMS']) == 1 and _in_function(
            syncs['in-graph NMS'][0], detections_to_host)
            and len(syncs['host NMS']) == 1,
            'a batch synced the host other than for its result copy (or the '
            'host NMS\'s candidate copy)')
        agreement = _nms_agreement(model, mtype, batch, dev)
        print(f'[34d NMS in-process] per sample: {agreement}')
        for a in agreement:
            check(a['converged'] and a['greedy_equal'],
                  f'the in-graph NMS is not the greedy NMS: {agreement}')
            check(a['host_exact'] or a['near_pairs_f64'] > 0,
                  f'the host NMS is not the greedy NMS over the f64 IoU: '
                  f'{agreement}')
        # The host NMS over the val set in this process, for the
        # --host-nms subprocess to be held to (cuDNN's TF32 as there).
        torch.backends.cudnn.allow_tf32 = True
        try:
            host_outputs = run_inference_generic(host_predict, model,
                                                 dataset, BATCH)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        inproc = os.path.join(tmp, 'inproc_host')
        dataset.format_results(host_outputs['bbox_results'], inproc,
                               config_factory(
                                   'detection_newsc_config_final').class_range)
        del model, predict, host_predict
        torch.cuda.empty_cache()

        # 34c-f: the CLIs as subprocesses on the dataroot.
        test = 'omnihd_scenes_tpu_torch.tools.test'
        outs = {k: os.path.join(tmp, k) for k in ('graph', 'host')}
        args = {k: [BEVFUSION_CONFIG, ckpts[BEVFUSION_CONFIG], '--eval',
                    '--out-dir', outs[k], '--cfg-options', *opts]
                for k in outs}
        args['host'].insert(3, '--host-nms')
        with ThreadPoolExecutor(2) as pool:
            runs = dict(zip(outs, pool.map(lambda k: _cli(test, *args[k]),
                                           outs)))
        metrics = {k: _finite_metrics(outs[k], f'tools.test {k}')
                   for k in outs}
        for k, (stdout, _) in runs.items():
            printed = _printed_launches(stdout)
            check(printed['lss_sample_bev'] == n_batches
                  and printed['rectify'] == printed['jpeg_idct']
                  == printed['jpeg_decode'] == n_batches
                  and printed['nvjpeg_decode'] == 0
                  and all(printed[n] == launches[n] for n in SETUP_KERNELS),
                  f'tools.test ({k} NMS) launches {printed}')
        graph_rows, host_rows, inproc_rows = (
            _kept_rows(d) for d in (outs['graph'], outs['host'], inproc))
        same = {tok: graph_rows[tok] == host_rows.get(tok) for tok in
                graph_rows}
        check(host_rows.keys() == inproc_rows.keys(),
              '--host-nms scored other samples than the val set')
        for tok in host_rows:
            check(host_rows[tok] == inproc_rows[tok],
                  f'--host-nms sample {tok}: other boxes than the host NMS '
                  'in this process')
        print(f'[34c tools.test --eval] {BEVFUSION_CONFIG} b{BATCH} from the '
              f'1080p JPEG dataroot ({gen_s:.1f} s to write, checkpoints '
              f'{ckpt_s:.1f} s): mAP {metrics["graph"]["mAP"]:.4f}, NOS '
              f'{metrics["graph"]["NOS"]:.4f} in {runs["graph"][1]:.1f} s '
              f'(whole process); launches '
              f'{_printed_launches(runs["graph"][0])}')
        print(f'[34d --host-nms] {runs["host"][1]:.1f} s: all {len(host_rows)} '
              f'samples keep the in-process host NMS\'s boxes bit for bit '
              f'({sum(sum(c.values()) for c in host_rows.values())} boxes); '
              f'{sum(same.values())} of {len(same)} samples keep the '
              f'in-graph run\'s boxes exactly; mAP '
              f'{metrics["host"]["mAP"]:.4f} (in-graph '
              f'{metrics["graph"]["mAP"]:.4f})')
        stdout, bench_s = _cli('omnihd_scenes_tpu_torch.tools.benchmark',
                               BEVFUSION_CONFIG, '--checkpoint',
                               ckpts[BEVFUSION_CONFIG], '--samples',
                               str(BENCH_SAMPLES), '--warmup', '2',
                               '--cfg-options', *opts)
        bench = json.loads(stdout.strip().splitlines()[-1])
        check(bench['samples'] >= BENCH_SAMPLES and bench['fps'] > 0
              and bench['decode'] == 'device', f'tools.benchmark {bench}')
        print(f'[34e tools.benchmark] {BEVFUSION_CONFIG} b{BATCH}, '
              f'{bench["samples"]} samples: {bench["fps"]:.3f} samples/s; ms '
              f'a sample: ' + ', '.join(
                  f'{k} {v:.3f}' for k, v in bench['ms_per_sample'].items())
              + f' ({bench_s:.1f} s whole process; {card})')

        def other(path):
            out = os.path.join(tmp, 'test_' + os.path.basename(path)[:-3])
            stdout, seconds = _cli(test, path, ckpts[path], '--eval',
                                   '--out-dir', out, '--cfg-options',
                                   *_camera_options(root, 1))
            return path, _finite_metrics(out, path), seconds, \
                _printed_launches(stdout)

        with ThreadPoolExecutor(len(CAMERA_CONFIGS)) as pool:
            for path, m, seconds, printed in pool.map(other, CAMERA_CONFIGS):
                lss = 0 if 'bevformer' in path else len(dataset)
                check(printed['lss_sample_bev'] == lss
                      and printed['jpeg_decode'] == printed['jpeg_idct']
                      == printed['rectify'] == len(dataset)
                      and printed['nvjpeg_decode'] == 0
                      and all(printed[n] >= 1 for n in SETUP_KERNELS),
                      f'{path} launches {printed}')
                print(f'[34f tools.test --eval] {path} b1: mAP '
                      f'{m["mAP"]:.4f}, NOS {m["NOS"]:.4f}'
                      + (f', occ mIoU {m["occ_mIoU"]:.4f}'
                         if 'occ_mIoU' in m else '')
                      + f' in {seconds:.1f} s; launches {printed}')
    print(f'[34 camera dataroots] {time.perf_counter() - t_phase:.1f} s with '
          f'cv2 and PIL blocked ({card})')
    return dict(launches=launches, rectify=rect_row, idct=idct_row,
                jpeg_max=jpeg_max, host=host, rectify_extra=rect_extra,
                setup=setup_rows)


# Phase 35: the full-width training run (configs/bevfusion.py, b4, two
# spawn workers) from a 1080p JPEG dataroot of TRAIN_SYNTH (16 train
# samples: 4 batches an epoch, TRAIN_EPOCHS epochs), its augmentations
# (the crop takes 720x408 of the 544x960 canvas back to 544x960), and the
# CLIs' small dataroot (SyntheticConfig's 108x192 cameras) and options.
TRAIN_SYNTH = dict(CAMERA_SYNTH, samples_per_scene=16)
TRAIN_EPOCHS = 2
TRAIN_CROP = (120, 68, 840, 476)
TRAIN_AUG = {'photometric': True,
             'crop_resize_flip': {'resize': [544], 'crop': TRAIN_CROP,
                                  'rand_flip': True},
             'rot_scale_flip_image': {}}
SYNTH_AUG = {'photometric': 'per_view',
             'crop_resize_flip': {'resize': [128], 'crop': (24, 16, 168, 112),
                                  'rand_flip': True},
             'rot_scale_flip_image': {}}
AUG_KERNELS = ('photometric', 'crop_resize_flip')


def _photometric_cases(n):
    """35a's photometric rows (n views each): every step off; brightness,
    contrast before the HSV steps, saturation, hue and a swap; contrast
    after them with a negative hue and another swap; independent per-view
    draws."""
    from omnihd_scenes_tpu_torch.data.augmentation import draw_photometric

    rows = {'all off': (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2),
            'mode 1, every step, swap': (1, -31.5, 1, 1, 1.4, 1, 0.6, 1,
                                         17.0, 1, 2, 0, 1),
            'mode 0, every step, swap': (1, 20.0, 0, 1, 0.55, 1, 1.45, 1,
                                         -17.9, 1, 1, 2, 0)}
    cases = {k: np.tile(np.asarray(v, np.float32), (n, 1))
             for k, v in rows.items()}
    cases['per-view draws'] = draw_photometric(np.random.RandomState(7), n,
                                               per_view=True)
    return cases


def _aug_kernels_on(dev, card, imgs):
    """35a: the two augmentation kernels against their plain versions on
    the card on a decoded b4 batch (24 x 544x960) -> their kernels-line
    rows (max |d|, ms, plain ms, bound ms, bound_by, library ms)."""
    import torch
    import torch.nn.functional as F

    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip, crop_resize_flip_bytes, crop_resize_flip_plain)
    from omnihd_scenes_tpu_torch.kernels.photometric import (
        photometric, photometric_bytes, photometric_plain)
    from omnihd_scenes_tpu_torch.tools.roofline import HBM_BYTES_PER_S

    n = imgs.shape[0]
    errs = {}
    for label, rows in _photometric_cases(n).items():
        got, want = photometric(imgs, rows), photometric_plain(imgs, rows)
        errs[label] = float((got - want).abs().max())
        check(torch.equal(got, want), f'photometric != plain ({label}: max '
              f'|d| {errs[label]})')
    rows = _photometric_cases(n)['per-view draws']
    ms = kernel_ms(lambda: photometric(imgs, rows), 'photometric_kernel',
                   20, 3)
    plain_ms = cuda_ms(lambda: photometric_plain(imgs, rows), 2, 1)
    nbytes = photometric_bytes(imgs)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f'[35a photometric] {n} x {imgs.shape[1]}x{imgs.shape[2]} f32, '
          f'one launch: bit-equal to plain on {list(errs)}; {ms:.4f} ms '
          f'against {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB; share '
          f'{bound / ms:.3f}), plain {plain_ms:.2f} ms, no single PyTorch '
          f'call to compare ({card})')
    photo_row = (max(errs.values()), ms, plain_ms, bound, 'bytes', None)

    x0, y0, x1, y1 = TRAIN_CROP
    out_hw = tuple(imgs.shape[1:3])
    crf = {}
    for label, flips in (('no flip', [0] * n), ('flip', [1] * n),
                         ('mixed', [i % 2 for i in range(n)])):
        rec = np.array([[out_hw[1], out_hw[0], *TRAIN_CROP, f]
                        for f in flips], np.int64)
        got, want = crop_resize_flip(imgs, rec), crop_resize_flip_plain(imgs,
                                                                        rec)
        crf[label] = float((got - want).abs().max())
        check(torch.equal(got, want), f'crop_resize_flip != plain ({label}: '
              f'max |d| {crf[label]})')
    ms2 = kernel_ms(lambda: crop_resize_flip(imgs, rec),
                    'crop_resize_flip_kernel', 20, 3)
    plain2 = cuda_ms(lambda: crop_resize_flip_plain(imgs, rec), 2, 1)
    crop = imgs[:, y0:y1, x0:x1].permute(0, 3, 1, 2).contiguous()
    lib = cuda_ms(lambda: F.interpolate(crop, size=out_hw, mode='bilinear',
                                        align_corners=False, antialias=False),
                  20, 3)
    nbytes2 = crop_resize_flip_bytes(imgs, rec)
    bound2 = nbytes2 / HBM_BYTES_PER_S * 1e3
    print(f'[35a crop_resize_flip] {n} crops {x1 - x0}x{y1 - y0} -> '
          f'{out_hw[1]}x{out_hw[0]}, one launch: bit-equal to plain '
          f'({crf}); {ms2:.4f} ms against {bound2:.4f} ms (bytes, '
          f'{nbytes2 / 1e6:.1f} MB; share {bound2 / ms2:.3f}), plain '
          f'{plain2:.2f} ms, F.interpolate (bilinear, NCHW crop) {lib:.4f} '
          f'ms ({card})')
    return photo_row, (max(crf.values()), ms2, plain2, bound2, 'bytes', lib)


def _plain_decode(batch, dev):
    """A host device-decode batch decoded with every kernel's plain
    version on the card (the host entropy decode, then the plain IDCT,
    ``rectify``, ``photometric`` and ``crop_resize_flip``) -> (imgs (B,
    N, H, W, 3), whether the IDCT kernel's planes equal the plain
    IDCT's)."""
    import torch

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data import jpeg as J
    from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip_plain)
    from omnihd_scenes_tpu_torch.kernels.photometric import (
        photometric_plain)

    offsets, data = batch[IL.JPEG_OFFSETS], batch[IL.JPEG_BYTES]
    blobs = [data[a:b] for row in offsets for a, b in zip(row[:-1], row[1:])]
    c = J.entropy_decode(blobs, pin=dev.type == 'cuda')
    planes = J.planes_of(JI.jpeg_idct_plain(c.coefs.to(dev), c.quant.to(dev),
                                            c.comps), c)
    kernel_planes, (maps, *args) = IL.decoded_sources(batch, dev)
    same = all(torch.equal(a, b) for p, q in zip(planes, kernel_planes)
               for a, b in zip(p[:3], q[:3]))
    imgs = R.rectify_plain(planes, maps, *args)
    imgs = photometric_plain(imgs, batch[IL.AUG_PHOTOMETRIC].reshape(
        imgs.shape[0], -1))
    rec = np.repeat(batch[IL.AUG_CROP_RESIZE_FLIP], offsets.shape[1] - 1, 0)
    imgs = crop_resize_flip_plain(imgs, rec)
    return imgs.reshape(offsets.shape[0], -1, *imgs.shape[1:]), same


def _train_cli(path, root, work, extra):
    """35c: ``tools.train`` on ``path`` as a subprocess on the JPEG
    dataroot ``root`` -> (its train.log.json records, seconds)."""
    import os

    args = [path, '--work-dir', work, '--cfg-options',
            *_camera_options(root, 2), *extra]
    _, seconds = _cli('omnihd_scenes_tpu_torch.tools.train', *args)
    with open(os.path.join(work, 'train.log.json')) as f:
        return [json.loads(line) for line in f], seconds


def _camera_train_run(cfg, dev, epochs, batch, workers):
    """35b: ``cfg``'s model trained on its train split from the JPEG
    dataroot, as ``tools.train`` trains it (``image_decode='device'``,
    ``TrainLoader`` with ``workers`` spawn workers -> ``run_training``'s
    prefetch, which decodes on its side stream -> the bf16-policy
    step), the launch counts zeroed just before and read just after ->
    steps, losses, launches, each step's host start time and CUDA events,
    each batch's host entropy decode ms and a copy of the first host batch
    with the images its step saw."""
    import torch

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data import jpeg as J
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import (anchors_for,
                                                       build_model_from_cfg,
                                                       init_model,
                                                       make_loss_fn_generic)
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step,
                                                    run_training)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    train = build_dataset_single(cfg.data.train, 'det',
                                 image_decode='device')
    loader = TrainLoader(train, batch, num_workers=workers)
    model, mtype = build_model_from_cfg(cfg)
    init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)
    steps = epochs * len(loader)
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(2e-4, steps, warmup_iters=2)))
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        model, mtype, anchors_for(model, mtype))))
    kept, walls, events, host_ms, losses = {}, [], [], [], []
    entropy = J.entropy_decode

    def timed_entropy(*a, **k):
        t = time.perf_counter()
        out = entropy(*a, **k)
        host_ms.append((time.perf_counter() - t) * 1e3)
        return out

    class Keep:
        """The loader, keeping a copy of its first host batch."""

        def set_epoch(self, e):
            loader.set_epoch(e)

        def __iter__(self):
            for b in loader:
                kept.setdefault('host', {k: np.array(v) for k, v in
                                         b.items()})
                yield b

    def spy(st, b):
        check(not set(IL.HOST_KEYS) & set(b) and b['imgs'].device == dev,
              'a train step got camera sources, not decoded images')
        kept.setdefault('imgs', b['imgs'].clone())
        walls.append(time.perf_counter())
        if dev.type == 'cuda':
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            out = step(st, b)
            e[1].record()
            events.append(e)
            return out
        return step(st, b)

    class Logger:
        def log(self, rec, echo=True):
            if rec.get('mode') == 'train':
                losses.append(rec['loss'])

    IL._DEVICE_MAPS.clear()
    R._TABLES.clear()
    _zero_launches()
    J.decode_jpeg_planes.calls = 0
    J.entropy_decode = timed_entropy
    t0 = time.perf_counter()
    try:
        state = run_training(state, spy, Keep(), epochs, logger=Logger(),
                             log_interval=1)
        if dev.type == 'cuda':
            torch.cuda.synchronize()
    finally:
        J.entropy_decode = entropy
        loader.close()
    seconds = time.perf_counter() - t0
    launches = dict(_read_launches(),
                    jpeg_decode=J.decode_jpeg_planes.calls)
    check(int(state.step) == steps == len(losses)
          and all(np.isfinite(losses)),
          f'{int(state.step)} of {steps} steps, losses {losses}')
    for name in ('jpeg_idct', 'rectify', 'jpeg_decode', 'lss_sample',
                 'lss_sample_backward') + AUG_KERNELS:
        check(launches[name] == steps, f'35b launches {launches}: {name} '
              f'{launches[name]} in {steps} steps')
    check(launches['rectify_pack_map'] >= 1 and launches['rectify_taps'] >= 1,
          f'35b setup launches {launches}')
    return dict(steps=steps, losses=losses, launches=launches, walls=walls,
                dev_ms=events, host_ms=host_ms, kept=kept, seconds=seconds,
                samples=len(train), depth=train.load_depth_gt)


def phase_camera_train(dev, card, step_ms):
    """35: camera training from a JPEG dataroot on the card, with cv2 and
    PIL blocked."""
    import os
    import sys
    import tempfile

    import torch

    from omnihd_scenes_tpu_torch.data import image_loading as IL
    from omnihd_scenes_tpu_torch.data.loader import EvalLoader
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)
    from omnihd_scenes_tpu_torch.tools import gen_depth_gt
    from omnihd_scenes_tpu_torch.train.config import Config
    from omnihd_scenes_tpu_torch.train.detection import build_dataset_single

    t_phase = time.perf_counter()
    with _blocked_modules('cv2', 'PIL'), \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        roots = {k: os.path.join(tmp, k) for k in ('full', 'small')}
        for key, cfg in (('full', SyntheticConfig(**TRAIN_SYNTH)),
                         ('small', SyntheticConfig())):
            generate(roots[key], 'v1.0-mini', cfg, images=True,
                     image_device='cuda')
            create_newscenes_infos(roots[key], roots[key], 'synth',
                                   version='v1.0-mini', max_sweeps=0)
            hw = cfg.image_hw
            for split in ('train', 'val'):
                gen_depth_gt.main([
                    f'{roots[key]}/synth_infos_temporal_{split}.pkl',
                    '--img-h', str(hw[0]), '--img-w', str(hw[1]),
                    '--workers', str(os.cpu_count() or 1)])
        gen_s = time.perf_counter() - t0

        # 35a: the kernels against their plain versions on a decoded b4
        # val batch.
        root = roots['full']
        cfg = Config.fromfile(BEVFUSION_CONFIG)
        cfg.merge_from_options(_camera_options(root, BATCH)
                               + ['data.workers_per_device=2'])
        val = build_dataset_single(cfg.data.val, 'det', image_decode='device')
        vbatch, _ = next(iter(EvalLoader(val, BATCH)))
        imgs = IL.decode_camera_batch(vbatch, dev)['imgs']
        imgs = imgs.reshape(-1, *imgs.shape[2:])
        photo_row, crf_row = _aug_kernels_on(dev, card, imgs)
        del imgs, vbatch

        # 35b: the training run through TrainLoader -> prefetch ->
        # train_step, the counts zeroed just before and read just after.
        cfg.data.train.aug = TRAIN_AUG
        run = _camera_train_run(cfg, dev, TRAIN_EPOCHS, BATCH, 2)
        steps, losses, launches = run['steps'], run['losses'], run['launches']
        walls, dev_ms, kept = run['walls'], run['dev_ms'], run['kept']
        check(steps == 8 and run['depth'], f'{steps} steps, not 8, or no '
              'depth targets')
        ms = [a.elapsed_time(b) for a, b in dev_ms]
        gaps = np.diff(walls) * 1e3
        busy = sum(ms[1:]) / (walls[-1] - walls[1] + ms[-1] / 1e3) / 1e3
        host_ms = run['host_ms']
        got, same_planes = _plain_decode(kept['host'], dev)
        err = float((got - kept['imgs']).abs().max())
        check(same_planes and torch.equal(got, kept['imgs']),
              f'35b: a training batch differs from its plain decode (max '
              f'|d| {err}, IDCT planes equal {same_planes})')
        print(f'[35b camera train] {BEVFUSION_CONFIG} b{BATCH} from '
              f'{run["samples"]} 1080p JPEG samples with depth GT and '
              f'{TRAIN_AUG}, 2 workers, bf16 policy: {steps} steps in '
              f'{run["seconds"]:.1f} s, losses '
              f'{[round(v, 3) for v in losses]}; step wall gaps {np.round(gaps, 1).tolist()} ms (mean of the last '
              f'{len(gaps) - 1}: {float(np.mean(gaps[1:])):.2f}) against '
              f'phase 15\'s {step_ms:.2f} ms on ready batches; step device '
              f'ms {np.round(ms, 2).tolist()}, main-stream busy share '
              f'{busy:.3f} over steps 2-{steps}; host entropy decode '
              f'{np.round(host_ms, 1).tolist()} ms a batch; launches '
              f'{launches}; cv2 imported: '
              f'{sys.modules.get("cv2") is not None} ({card})')
        print(f'[35b plain decode] the first training batch the step saw '
              f'({tuple(got.shape)}) equals the same batch decoded with '
              f'every kernel\'s plain version on the card: max |d| {err}')
        sample_ms = {}
        for depth in (True, False):
            ds = build_dataset_single(dict(cfg.data.train.to_dict(),
                                           load_depth_gt=depth), 'det',
                                      image_decode='device')
            t0 = time.perf_counter()
            for i in range(BATCH):
                ds[i]
            sample_ms[depth] = (time.perf_counter() - t0) / BATCH * 1e3
        print(f'[35b host feed] one process: {sample_ms[True]:.1f} ms a '
              f'training sample with its depth targets, '
              f'{sample_ms[False]:.1f} ms without; {os.cpu_count()} CPUs, '
              f'{_cpu_model()}')
        del run, got, kept
        torch.cuda.empty_cache()

        # 35c: tools.train as subprocesses on the small JPEG dataroot.
        small = roots['small']
        aug = [f'data.train.aug={SYNTH_AUG}']
        jobs = {'bevfusion_synth': ('configs/synthetic/bevfusion_synth.py',
                                    aug + ['eval_interval=1']),
                'bevformer_synth': ('configs/synthetic/bevformer_synth.py',
                                    [])}
        with ThreadPoolExecutor(len(jobs)) as pool:
            runs = dict(zip(jobs, pool.map(
                lambda k: _train_cli(jobs[k][0], small,
                                     os.path.join(tmp, k), jobs[k][1]),
                jobs)))
        for key, (records, seconds) in runs.items():
            env = [r for r in records if r.get('mode') == 'env']
            done = [r for r in records if r.get('mode') == 'done']
            trains = [r['loss'] for r in records if r.get('mode') == 'train']
            vals = [r for r in records if r.get('mode') == 'val']
            kl = done[0]['kernel_launches'] if done else {}
            check(env and env[0]['device'].startswith('cuda') and trains
                  and all(np.isfinite(trains)),
                  f'tools.train {key}: {records[:3]} ...')
            check(kl.get('jpeg_idct', 0) >= len(trains)
                  and kl.get('rectify', 0) >= len(trains),
                  f'tools.train {key} launches {kl}')
            if key == 'bevfusion_synth':
                check(vals and np.isfinite(vals[0]['mAP'])
                      and np.isfinite(vals[0]['NOS'])
                      and kl['photometric'] == kl['crop_resize_flip']
                      == len(trains), f'tools.train {key}: {vals} {kl}')
            print(f'[35c tools.train] {jobs[key][0]} from the 108x192 JPEG '
                  f'dataroot on {env[0]["device"]}: exit 0 in {seconds:.1f} '
                  f's, {len(trains)} steps, losses '
                  f'{[round(v, 3) for v in trains]}'
                  + (f', mAP {vals[0]["mAP"]:.4f}, NOS {vals[0]["NOS"]:.4f}'
                     if vals else '') + f'; launches {kl}')
    check('cv2' not in sys.modules, 'cv2 was imported')
    print(f'[35 camera training] {time.perf_counter() - t_phase:.1f} s with '
          f'cv2 and PIL blocked (dataroots, infos and depth GT '
          f'{gen_s:.1f} s; {card})')
    return dict(launches=launches, photometric=photo_row,
                crop_resize_flip=crf_row)


def randomize_bn(state_dict, seed):
    """``state_dict`` with every BatchNorm's scale, bias and statistics
    drawn away from (0, 1) as JAX's ``tests/test_fuse_conv_bn.py:
    _randomize_bn`` draws them (scale U(0.5, 1.5), bias N(0, 0.1), mean
    N(0, 0.3), var U(0.5, 1.5)), from ``seed``."""
    import torch

    rng = np.random.RandomState(seed)
    sd = dict(state_dict)
    for key in sorted(k[:-len('.running_mean')] for k in sd
                      if k.endswith('.running_mean')):
        n = sd[f'{key}.weight'].shape[0]
        for leaf, v in (('weight', rng.rand(n) + 0.5),
                        ('bias', rng.randn(n) * 0.1),
                        ('running_mean', rng.randn(n) * 0.3),
                        ('running_var', rng.rand(n) + 0.5)):
            sd[f'{key}.{leaf}'] = torch.from_numpy(v.astype(np.float32))
    return sd


BN_KERNEL = re.compile(r'batch_norm|bn_fw|bn_inf', re.I)


def _request_kernels(fn):
    """One ``fn()`` under torch.profiler: (``aten::batch_norm`` calls,
    {device kernel name: (launches, device us)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls, kernels = 0, {}
    for e in prof.key_averages():
        if e.key == 'aten::batch_norm':
            calls += e.count
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'device_time_total', 0) or e.cuda_time_total
            kernels[e.key] = (e.count, us)
    return calls, kernels


def phase_fuse(dev, card):
    """36: conv-BN fusion of the full-width serving model (seeded weights,
    BN statistics of ``randomize_bn``), traced on the card in f32: the
    pairs fused and skipped; f32 fused against f32 unfused and b4 bf16
    fused against bf16 unfused on one request; each bf16 Predictor's
    request ms (1 + 3 fresh b4 requests each, two rounds alternating);
    the BatchNorm launches of one request of each."""
    import torch

    from omnihd_scenes_tpu_torch.config import serving_config
    from omnihd_scenes_tpu_torch.models.anchor_head import (
        anchor_head_get_bboxes)
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.fuse import fuse_model
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)
    from omnihd_scenes_tpu_torch.weights import load_state_dict

    t_phase = time.perf_counter()
    cfg = serving_config()
    sd = randomize_bn(random_state_dict(cfg, seed=0), seed=36)
    rng = np.random.RandomState(36)
    model = BEVFusion(cfg)
    load_state_dict(model, sd)
    model.to(dev)
    trace = [torch.from_numpy(x).to(dev)
             for x in random_request(rng, cfg, 1)]
    t0 = time.perf_counter()
    fused, report = fuse_model(model, lambda: model(*trace))
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    fused = {k: v.cpu() for k, v in fused.items()}
    del model, trace
    torch.cuda.empty_cache()
    pairs, skipped = len(report['fused']), report['skipped']
    print(f'[36 fuse] serving_config(): {pairs} BN folded, {len(skipped)} '
          f'skipped {skipped[:5]}; traced, fused and verified on the card '
          f'in {fuse_s:.1f} s ({card})')
    check(pairs > 0 and not skipped and report.get('verified'),
          f'fusion: {pairs} fused, skipped {skipped}')

    keys = ('bev', 'cls_score', 'bbox_pred', 'dir_pred')
    request = random_request(rng, cfg, BATCH)
    for dtype, limit in ((torch.float32, F32_FUSE_TOL),
                         (torch.bfloat16, HEAD_TOL)):
        outs, dets = [], []
        for s in (sd, fused):
            p = Predictor(cfg, s, device=dev, dtype=dtype)
            outs.append({k: v.float() for k, v in p.forward(*request).items()
                         if k in keys})
            dets.append([t.cpu() for t in anchor_head_get_bboxes(
                *(outs[-1][k] for k in keys[1:]), p.anchors)])
            del p
            torch.cuda.empty_cache()
        want, got = outs
        rel = {k: float((got[k] - want[k]).abs().max()
                        / want[k].abs().max()) for k in keys}
        score_d = float((torch.sigmoid(got['cls_score'])
                         - torch.sigmoid(want['cls_score'])).abs().max())
        rows = [kept_row_distance(dets[1], dets[0], s) for s in range(BATCH)]
        kept = [int(d[3].sum()) for d in dets]
        share = box_match(dets[1][0], dets[1][2], dets[1][3], dets[0][0],
                          dets[0][2], dets[0][3])
        name = str(dtype).split('.')[-1]
        print(f'[36 fuse {name}] fused vs unfused, b{BATCH}: head maps off '
              f'by ' + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
              + f' of max|unfused| (limit {limit}); largest score '
              f'difference {score_d:.3e}; kept boxes {kept[1]} / {kept[0]}, '
              f'kept-row distance per sample {[f"{r:.2e}" for r in rows]}, '
              f'{share:.4f} of fused boxes matched')
        check(all(v <= limit for v in rel.values()),
              f'{name} fused head maps off the unfused ones: {rel}')
        check(kept[0] > 0 and share >= BOX_MATCH,
              f'{name} fused kept boxes match for only {share:.4f}')

    preds = {'unfused': Predictor(cfg, sd, device=dev, dtype=torch.bfloat16),
             'fused': Predictor(cfg, fused, device=dev, dtype=torch.bfloat16)}
    ms = {name: [] for name in preds}
    for _ in range(2):
        for name, p in preds.items():
            reqs = [random_request(rng, cfg, BATCH)
                    for _ in range(1 + N_TIMED)]
            ms[name] += _timed_requests(dev, p, reqs)[0]
    launches = _timed_requests(dev, preds['fused'], [request])[1][-1]
    prof = {name: _request_kernels(lambda: p(*request))
            for name, p in preds.items()}
    calls = {name: v[0] for name, v in prof.items()}
    bn = {name: sum(n for k, (n, _) in v[1].items() if BN_KERNEL.search(k))
          for name, v in prof.items()}
    mean = {name: float(np.mean(v)) for name, v in ms.items()}
    print(f'[36 fuse bf16] b{BATCH} request: unfused {mean["unfused"]:.2f} '
          f'ms ({np.round(ms["unfused"], 2).tolist()}), fused '
          f'{mean["fused"]:.2f} ms ({np.round(ms["fused"], 2).tolist()}) by '
          f'CUDA events, fresh inputs, two rounds alternating ({card}); '
          f'BatchNorm in one request (aten::batch_norm calls, device '
          f'kernels named like a BatchNorm): unfused ({calls["unfused"]}, '
          f'{bn["unfused"]}), fused ({calls["fused"]}, {bn["fused"]}) for '
          f'{pairs} pairs; lss_sample_bev {launches} a request')
    # The kernels whose launches or device time moved most, by the
    # profiler (us summed over one request).
    names = set(prof['unfused'][1]) | set(prof['fused'][1])
    moved = sorted(names, key=lambda k: -abs(
        prof['fused'][1].get(k, (0, 0))[1]
        - prof['unfused'][1].get(k, (0, 0))[1]))
    for k in moved[:6]:
        (n0, t0), (n1, t1) = (prof[name][1].get(k, (0, 0))
                              for name in ('unfused', 'fused'))
        print(f'[36 fuse bf16]   {k[:90]}: launches {n0} -> {n1}, device '
              f'{t0 / 1e3:.3f} -> {t1 / 1e3:.3f} ms')
    total = {name: sum(t for _, t in v[1].values()) / 1e3
             for name, v in prof.items()}
    print(f'[36 fuse bf16] device time of one profiled request: unfused '
          f'{total["unfused"]:.2f} ms, fused {total["fused"]:.2f} ms')
    per_bn = bn['unfused'] // max(calls['unfused'], 1)
    check(calls['unfused'] - calls['fused'] == pairs and per_bn >= 1
          and bn['unfused'] - bn['fused'] == per_bn * pairs,
          f'the fused request\'s BatchNorm calls fell by '
          f'{calls["unfused"] - calls["fused"]} and its kernels by '
          f'{bn["unfused"] - bn["fused"]}, not {pairs} and {per_bn} x '
          f'{pairs}')
    del preds
    torch.cuda.empty_cache()
    print(f'[36 fuse] {time.perf_counter() - t_phase:.1f} s')
    return dict(cfg=cfg, fused=fused, pairs=pairs, ms=mean,
                request=launches)


# The child process of phase 37: loads a bundle with no model code, runs
# the saved requests on the card and reports (argv: bundle, inputs .npz,
# outputs .pt, requests).
EXPORT_CHILD = r'''
import json, sys, time
import numpy as np, torch
bundle, inputs, outputs, n = sys.argv[1:5]
t0 = time.perf_counter()
from omnihd_scenes_tpu_torch.serve.export import load_exported
from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
model = load_exported(bundle, 'cuda')
load_s = time.perf_counter() - t0
arrays = np.load(inputs)
k = len(model.input_specs)
lss_sample_bev.launches = 0
ms, outs = [], []
for i in range(int(n)):
    req = [arrays[f'arr_{i * k + j}'] for j in range(k)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = model(*req)
    end.record()
    torch.cuda.synchronize()
    ms.append(start.elapsed_time(end))
    outs.append([t.cpu() for t in out])
torch.save(outs, outputs)
print(json.dumps({'load_s': load_s, 'ms': ms,
                  'launches': lss_sample_bev.launches,
                  'models': sorted(m for m in sys.modules if m.startswith(
                      'omnihd_scenes_tpu_torch.models')),
                  'jax': 'jax' in sys.modules}))
'''


def phase_export(dev, card, cfg, fused):
    """37: the fused b4 bf16 model exported (``serve/export.py``, the LSS
    kernel as the registered op) into a temporary bundle, loaded in a
    fresh process that imports no model code, 1 + 3 fresh b4 requests
    there: outputs against the live ``Predictor``'s, the op's launches
    inside the program, request ms, export seconds."""
    import os
    import sys
    import tempfile

    import torch

    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.export import META, export_model
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    rng = np.random.RandomState(37)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, 'bundle')
        t0 = time.perf_counter()
        export_model(BEVFusion(cfg), 'bevfusion', fused, requests[0], bundle,
                     anchors=cfg.pillars.anchors(), bf16=True, device=dev)
        wall_s = time.perf_counter() - t0
        meta = json.load(open(os.path.join(bundle, META)))
        sizes = {f: os.path.getsize(os.path.join(bundle, f)) / 2 ** 20
                 for f in sorted(os.listdir(bundle))}
        torch.cuda.empty_cache()
        inputs = os.path.join(tmp, 'inputs.npz')
        outputs = os.path.join(tmp, 'outputs.pt')
        np.savez(inputs, *[a for req in requests for a in req])
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', EXPORT_CHILD, bundle, inputs, outputs,
             str(len(requests))], capture_output=True, text=True, cwd=root,
            timeout=600, env=dict(os.environ, PYTHONPATH=root))
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0, f'the bundle\'s process failed: '
              f'{proc.stderr[-3000:]}')
        seen = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(outputs)
    live = Predictor(cfg, fused, device=dev, dtype=torch.bfloat16)
    want = [[t.cpu() for t in live(*req)] for req in requests]
    again = [[t.cpu() for t in live(*req)] for req in requests]
    del live
    torch.cuda.empty_cache()

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    equal = sum(map(same, got, want))
    self_equal = sum(map(same, again, want))
    shares = [box_match(g[0], g[2], g[3], w[0], w[2], w[3])
              for g, w in zip(got, want)]
    self_shares = [box_match(a[0], a[2], a[3], w[0], w[2], w[3])
                   for a, w in zip(again, want)]
    kept = [(int(g[3].sum()), int(w[3].sum())) for g, w in zip(got, want)]
    ms = float(np.mean(seen['ms'][1:]))
    print(f'[37 export] fused b{BATCH} bf16 bundle '
          f'{ {k: round(v, 2) for k, v in sizes.items()} } MiB: '
          f'torch.export {meta["export_seconds"]:.1f} s, export_model in '
          f'all {wall_s:.1f} s; a fresh process (models imported: '
          f'{seen["models"]}, jax: {seen["jax"]}) loaded it in '
          f'{seen["load_s"]:.1f} s ({child_s:.1f} s with its start) and ran '
          f'1 + {N_TIMED} requests: {ms:.2f} ms/request by CUDA events '
          f'({np.round(seen["ms"][1:], 2).tolist()}), lss_sample_bev '
          f'launches inside the program {seen["launches"]} ({card})')
    print(f'[37 export] against the live Predictor on the same requests: '
          f'{equal} of {len(requests)} bit-equal, kept boxes {kept}, share '
          f'of the bundle\'s kept boxes matched {np.round(shares, 4).tolist()}'
          f'; the live Predictor against itself (the pillar sums add with '
          f'atomics): {self_equal} of {len(requests)} bit-equal, '
          f'{np.round(self_shares, 4).tolist()} matched')
    check(not seen['models'] and not seen['jax'],
          f'the bundle\'s process imported {seen["models"]} / jax')
    check(seen['launches'] == len(requests),
          f'lss_sample_bev launched {seen["launches"]} times in '
          f'{len(requests)} requests of the exported program')
    check(all(a == b for a, b in kept) and min(shares) >= EXPORT_BOX_MATCH,
          f'the bundle\'s outputs are off the live Predictor\'s: kept '
          f'{kept}, matched {shares}')
    return dict(launches=seen['launches'], ms=ms,
                export_s=meta['export_seconds'])


def phase_qat(dev, card, cfg, state_dict):
    """38: quantization-aware training of the full-width serving model, b4
    under the bf16 policy: 4 ``make_train_step`` steps in ``qat`` (finite
    losses, every QConv2d and the stem with a finite act_amax > 0, one
    LSS forward and one backward launch a step), then ``freeze`` and the
    int8 tier served: 1 + 3 fresh b4 requests, qconv once per eligible
    layer (36) a request."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.models.quant import (QConv2d, quant_state,
                                                      set_mode)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_train_batch)
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import batch_to, make_train_step

    rng = np.random.RandomState(38)
    state = _train_state(cfg, state_dict, dev, lr=2e-4)
    model = state.model
    set_mode(model, 'qat')
    step = make_train_step(bf16_policy(make_loss_fn_generic(
        model, 'bevfusion', cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range)))
    batches = [batch_to(random_train_batch(rng, cfg, BATCH), dev)
               for _ in range(QAT_STEPS)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    lss_sample_bev.launches = lss_sample_bev_backward.launches = 0
    dev_ms, losses = [], []
    for b in batches:
        start.record()
        state, loss, _ = step(state, b)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    train = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del batches
    amax = {n: m.act_amax for n, m in model.named_modules()
            if isinstance(m, QConv2d)}
    values = [float('nan') if v is None else float(v)
              for v in amax.values()]
    check(all(np.isfinite(losses)), f'QAT losses {losses}')
    check(train == (QAT_STEPS, QAT_STEPS), f'QAT (LSS forward, backward) '
          f'launches {train}, not one each a step')
    check(all(np.isfinite(values)) and min(values) > 0,
          f'act_amax not finite and positive: {min(values)}')
    print(f'[38 qat] serving_config() b{BATCH}, bf16 policy, qat mode: '
          f'{QAT_STEPS} steps {np.round(dev_ms, 2).tolist()} ms by CUDA '
          f'events (first with warm-up), peak {peak:.2f} GiB ({card}); '
          f'losses {[round(v, 4) for v in losses]}; act_amax of {len(amax)} '
          f'QConv2d (the stem among them) in [{min(values):.3e}, '
          f'{max(values):.3e}]; (LSS forward, backward) launches {train}')

    set_mode(model, 'freeze')
    model.eval()
    with torch.no_grad():
        model(*(None if x is None else torch.from_numpy(x).to(dev)
                for x in random_request(rng, cfg, 1)))
    qstate = quant_state(model)
    weights = model.state_dict()
    del state, step, model
    torch.cuda.empty_cache()
    int8 = Predictor(cfg, weights, device=dev, dtype=torch.bfloat16,
                     quant_state=qstate)
    eligible = _eligible_layers(int8.model)
    requests = [random_request(rng, cfg, BATCH) for _ in range(1 + N_TIMED)]
    qconv3x3.launches = 0
    # Served as phase 10 serves the int8 tier: TF32 on (it holds the f32
    # convs of int8 codes exactly).
    torch.backends.cudnn.allow_tf32 = True
    try:
        ms, lss, _, outs = _timed_requests(dev, int8, requests)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    q_launches = qconv3x3.launches
    boxes, scores, _, valid = outs[-1]
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all())
          and int(valid.sum()) > 0, 'non-finite or empty QAT int8 output')
    check(eligible == QCONV_PER_REQUEST
          and q_launches == eligible * len(requests),
          f'qconv launches {q_launches} for {len(requests)} requests, '
          f'{eligible} eligible layers (expected {QCONV_PER_REQUEST})')
    mean = float(np.mean(ms))
    print(f'[38 qat int8] frozen after QAT ({len(qstate)} quant tensors): '
          f'{N_TIMED} b{BATCH} requests (+1 warm-up) {mean:.2f} ms/request '
          f'({np.round(ms, 2).tolist()}) by CUDA events ({card}); qconv3x3 '
          f'{q_launches // len(requests)} launches a request, lss_sample_bev '
          f'{lss}; kept boxes {int(valid.sum())}')
    del int8
    torch.cuda.empty_cache()
    return dict(train_fwd=train[0], train_back=train[1],
                qconv_request=q_launches // len(requests), ms=mean,
                lss_request=lss[-1] // len(requests))


def sca_hits(cfg, lidar2img):
    """Hit queries per camera of one rig (any z-anchor inside the image)."""
    import torch

    from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
        get_reference_points_3d, point_sampling)

    ref = torch.from_numpy(get_reference_points_3d(
        cfg.bev_h, cfg.bev_w, 4, cfg.pc_range[5] - cfg.pc_range[2]))
    _, mask = point_sampling(ref, cfg.pc_range,
                             torch.as_tensor(lidar2img)[None], cfg.img_hw)
    return mask[0].any(-1).sum(-1)


# Phase 39: data-parallel training.  39b runs DP_RANKS ranks of
# DP_LOCAL samples on cuda:0 over gloo; 39c one rank a GPU over NCCL on
# up to DP_MAX_GPUS cards.  Bounds against the one-process run of the
# same global batch under the bf16 policy: two one-process runs of its
# 1 + 3 steps differed by 1.12e-4 in a loss and 7.53 learning rates in a
# parameter on one H100 (atomic backward kernels; AdamW moves a weight
# whose gradient is near 0 by up to a learning rate either way a step).
DP_RANKS = 2
DP_LOCAL = 2
DP_MAX_GPUS = 4
DP_LR = 2e-4
DP_LOSS_TOL = 1e-2
DP_PARAM_LR = 2.5


@contextlib.contextmanager
def _counted_collectives():
    """Count the ``torch.distributed`` collectives issued inside."""
    import torch.distributed as dist

    names = ('all_reduce', 'broadcast', 'all_gather', 'barrier')
    saved = {n: getattr(dist, n) for n in names}
    count = [0]

    def counted(fn):
        def call(*args, **kwargs):
            count[0] += 1
            return fn(*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counted(saved[n]))
    try:
        yield count
    finally:
        for n in names:
            setattr(dist, n, saved[n])


def _dp_steps(dev, cfg, state_dict, batches):
    """1 + N_TIMED bf16-policy steps of full-width BEVFusion from
    ``state_dict`` on this process's rows of each global batch (the whole
    batch without a data-parallel group; rank 0's weights broadcast
    first): {'losses' (the ranks' means), 'ms' (a step, CUDA events),
    'all_reduce_ms' (the gradients' all-reduce), 'peak_gib', 'launches'
    ((LSS forward, backward) after each step), 'collectives' (issued in
    the steps, the loss reads included), 'state' (floating state after
    the last step, on the host)}."""
    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.parallel import mesh
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import (_read_scalars, batch_to,
                                                    make_train_step)

    state = _train_state(cfg, state_dict, dev, DP_LR)
    mesh.broadcast_state(state.model)
    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    step = make_train_step(bf16_policy(make_loss_fn_generic(
        state.model, 'bevfusion', cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range)), mark=mark)
    local = [batch_to(mesh.shard_batch(b), dev) for b in batches]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {'losses': [], 'ms': [], 'all_reduce_ms': [], 'launches': []}
    lss_sample_bev.launches = lss_sample_bev_backward.launches = 0
    with _counted_collectives() as collectives:
        for b in local:
            events.clear()
            start.record()
            state, loss, _ = step(state, b)
            end.record()
            torch.cuda.synchronize(dev)
            out['ms'].append(start.elapsed_time(end))
            if 'all_reduce' in events:
                out['all_reduce_ms'].append(
                    events['backward'].elapsed_time(events['all_reduce']))
            out['launches'].append((lss_sample_bev.launches,
                                    lss_sample_bev_backward.launches))
            out['losses'].append(_read_scalars(loss, {})['loss'])
    out['collectives'] = collectives[0]
    out['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out['state'] = {k: v.cpu() for k, v in state.model.state_dict().items()
                    if v.is_floating_point()}
    del state, step, local
    torch.cuda.empty_cache()
    return out


def _dp_rank(rank, world, backend, same_device, directory):
    """One rank of phases 39b / 39c (a spawned process): the group from a
    file rendezvous in ``directory``, :func:`_dp_steps` on its rows of the
    spec's batches, its result saved to ``rank<r>.pt`` (or its error)."""
    import os
    import traceback

    import torch

    from omnihd_scenes_tpu_torch.parallel import distributed

    result = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device('cuda', 0 if same_device else rank)
        torch.cuda.set_device(dev)
        distributed.init_distributed(
            'cuda', backend=backend, rank=rank, world_size=world,
            init_method=f'file://{os.path.join(directory, "rdzv")}')
        spec = torch.load(os.path.join(directory, 'spec.pt'),
                          weights_only=False)
        result = _dp_steps(dev, spec['cfg'], spec['state_dict'],
                           spec['batches'])
    except BaseException:
        result = {'error': f'rank {rank}: {traceback.format_exc()}'}
    finally:
        distributed.destroy_distributed()
        torch.save(result, os.path.join(directory, f'rank{rank}.pt'))


def _dp_launch(world, backend, same_device, cfg, state_dict, batches,
               timeout=900):
    """Run :func:`_dp_rank` on ``world`` spawned ranks; their results."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        torch.save({'cfg': cfg, 'state_dict': state_dict,
                    'batches': batches}, os.path.join(tmp, 'spec.pt'))
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=_dp_rank,
                             args=(r, world, backend, same_device, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(not hung, f'ranks {hung} did not finish in {timeout} s')
        out = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                          weights_only=False) for r in range(world)]
    errors = [o['error'] for o in out if 'error' in o]
    check(not errors, 'a data-parallel rank failed:\n' + '\n'.join(errors))
    return out


def _dp_against(ranks, one, label):
    """Every rank's state equal to rank 0's bit for bit; losses and
    parameters against the one-process run: (max relative loss gap, max
    parameter gap in learning rates)."""
    import torch

    for r, res in enumerate(ranks[1:], 1):
        check(res['losses'] == ranks[0]['losses'],
              f'{label}: rank {r} logged other losses')
        for k, v in ranks[0]['state'].items():
            check(torch.equal(res['state'][k], v),
                  f'{label}: rank {r} differs from rank 0 in {k}')
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]['losses'], one['losses']))
    param_gap = max(float((ranks[0]['state'][k] - v).abs().max())
                    for k, v in one['state'].items()
                    if 'running' not in k) / DP_LR
    return loss_gap, param_gap


def _dp_torchrun(card):
    """39d: ``tools.train`` under ``torchrun --nproc_per_node 1`` on a
    synthetic radar dataroot on the card."""
    import os
    import sys
    import tempfile

    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)

    with tempfile.TemporaryDirectory() as tmp:
        root, work = os.path.join(tmp, 'synth'), os.path.join(tmp, 'work')
        generate(root, 'v1.0-mini', SyntheticConfig(), images=False)
        create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                               max_sweeps=0)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', '1', '-m',
             'omnihd_scenes_tpu_torch.tools.train',
             'configs/synthetic/pointpillars_radar_synth.py', '--work-dir',
             work, '--cfg-options', f'dataroot={root}',
             f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
             f'data.val.ann_file={root}/synth_infos_temporal_val.pkl'],
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f'torchrun tools.train exited '
              f'{proc.returncode}: {proc.stderr[-3000:]}')
        with open(os.path.join(work, 'train.log.json')) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')))
    done, env = records[-1], records[0]
    val = [r for r in records if r['mode'] == 'val']
    check(done['mode'] == 'done' and done['world_size'] == 1
          and env['device'].startswith('cuda') and ckpts == ['ckpt_2.pt']
          and len(val) == 1 and np.isfinite(val[0]['NOS']),
          f'torchrun tools.train: {done}, {env}, {ckpts}, {val}')
    print(f'[39d torchrun] tools.train under torchrun --nproc_per_node 1 '
          f'({env["device_name"]}, {card}): {seconds:.1f} s (whole '
          f'launch), {done["final_step"]} steps, world_size '
          f'{done["world_size"]}, backend {done["backend"]}, NOS '
          f'{val[0]["NOS"]:.4f}, {ckpts}')


def phase_data_parallel(dev, card, b4_ms):
    """Phase 39: data-parallel training of full-width ``configs/
    bevfusion.py`` under the bf16 policy, global batch DP_RANKS x
    DP_LOCAL, 1 + N_TIMED steps (TF32 off): 39a one rank over NCCL
    against the one-process run; 39b DP_RANKS ranks on cuda:0 over gloo;
    39c one rank a GPU over NCCL when there are several; 39d
    ``tools.train`` under torchrun.  Returns {run: (LSS forward, backward)
    launches a rank after its steps}.

    The one-process steps do not repeat bit for bit on the card (cuDNN's
    weight gradients, the bilinear upsampling's and max pooling's
    backward add with atomics; deterministic cuDNN alone made a step
    5.7 s and still did not repeat), so 39a holds the W = 1 run to the
    first step's loss bit for bit (the forward is deterministic), to no
    collective inside its steps (at W = 1 every reduction is skipped:
    the one-process path), and to 39b's bounds, beside a second
    one-process run's spread."""
    import socket

    import torch
    import torch.distributed as dist

    from omnihd_scenes_tpu_torch.config import BEVFusionConfig
    from omnihd_scenes_tpu_torch.parallel import distributed
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                         random_train_batch)

    cfg = BEVFusionConfig()
    sd = random_state_dict(cfg, seed=0)
    rng = np.random.RandomState(390)
    batches = [random_train_batch(rng, cfg, DP_RANKS * DP_LOCAL)
               for _ in range(1 + N_TIMED)]
    launches = {}
    one = _dp_steps(dev, cfg, sd, batches)
    again = _dp_steps(dev, cfg, sd, batches)
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    distributed.init_distributed(
        'cuda', backend='nccl', init_method=f'tcp://localhost:{port}',
        rank=0, world_size=1)
    try:
        probe = torch.full((4,), 3.0, device=dev)
        dist.all_reduce(probe)
        check(bool((probe == 3.0).all()), 'NCCL all-reduce of one rank')
        w1 = _dp_steps(dev, cfg, sd, batches)
        backend = dist.get_backend()
    finally:
        distributed.destroy_distributed()
    spread = _dp_against([again], one, '39a')
    loss_gap, param_gap = _dp_against([w1], one, '39a')
    ms1, ms0 = float(np.mean(w1['ms'][1:])), float(np.mean(one['ms'][1:]))
    print(f'[39a data parallel W=1] {backend}, b{DP_RANKS * DP_LOCAL}, '
          f'{N_TIMED} steps (+1): {ms1:.2f} ms/step ({w1["ms"][1:]}) vs '
          f'{ms0:.2f} without a group and phase 15 b4 {b4_ms:.2f} ({card}); '
          f'peak {w1["peak_gib"]:.2f} GiB; {w1["collectives"]} collectives '
          f'in its steps; first loss {w1["losses"][0]!r} vs {one["losses"][0]!r}'
          f' without a group; against that run: losses {loss_gap:.2e}, '
          f'parameters {param_gap:.3f} learning rates (a second run without '
          f'a group: {spread[0]:.2e}, {spread[1]:.3f}); (LSS forward, '
          f'backward) launches after each step {w1["launches"]}')
    check(w1['collectives'] == 0, 'the W = 1 steps issued collectives')
    check(w1['losses'][0] == one['losses'][0],
          'the W = 1 forward differs from the one-process forward')
    check(loss_gap <= DP_LOSS_TOL
          and param_gap <= DP_PARAM_LR * (1 + N_TIMED),
          'the W = 1 run is off the one-process run')
    launches['w1_nccl'] = w1['launches'][-1]

    ranks = _dp_launch(DP_RANKS, 'gloo', True, cfg, sd, batches)
    loss_gap, param_gap = _dp_against(ranks, one, '39b')
    for r, res in enumerate(ranks):
        print(f'[39b data parallel W={DP_RANKS} gloo] rank {r} on cuda:0, '
              f'b{DP_LOCAL} of b{DP_RANKS * DP_LOCAL}: '
              f'{np.mean(res["ms"][1:]):.2f} ms/step ({res["ms"][1:]}), '
              f'gradient all-reduce (gloo through the host) '
              f'{np.mean(res["all_reduce_ms"][1:]):.2f} ms '
              f'({res["all_reduce_ms"][1:]}), '
              f'{res["collectives"] / (1 + N_TIMED):.0f} collectives a step '
              f'(BatchNorm moments and their gradients, the depth loss\'s '
              f'count, the gradients, the loss read), peak '
              f'{res["peak_gib"]:.2f} GiB ({card}); (LSS forward, backward) '
              f'launches after each step {res["launches"]}')
        check(res['launches'] == [(k, k) for k in range(1, 2 + N_TIMED)],
              f'rank {r}: (LSS forward, backward) launches '
              f'{res["launches"]}, not one each a step')
        launches[f'w{DP_RANKS}_gloo_rank{r}'] = res['launches'][-1]
    print(f'[39b data parallel W={DP_RANKS} gloo] every rank\'s state '
          f'bit-equal to rank 0\'s; against the one-process b'
          f'{DP_RANKS * DP_LOCAL} run: losses {ranks[0]["losses"]} vs '
          f'{one["losses"]} (worst {loss_gap:.2e} relative, bound '
          f'{DP_LOSS_TOL}), parameters within {param_gap:.3f} learning '
          f'rates (bound {DP_PARAM_LR} a step, {1 + N_TIMED} steps)')
    check(all(np.isfinite(ranks[0]['losses'])), 'non-finite losses')
    check(loss_gap <= DP_LOSS_TOL
          and param_gap <= DP_PARAM_LR * (1 + N_TIMED),
          'the data-parallel run is off the one-process run')
    del ranks

    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        print(f'[39c data parallel NCCL] 39c not run: {n_gpus} device')
    else:
        world = min(n_gpus, DP_MAX_GPUS)
        rng = np.random.RandomState(391)
        batches = [random_train_batch(rng, cfg, world * DP_LOCAL)
                   for _ in range(1 + N_TIMED)]
        one = _dp_steps(dev, cfg, sd, batches)
        ranks = _dp_launch(world, 'nccl', False, cfg, sd, batches)
        loss_gap, param_gap = _dp_against(ranks, one, '39c')
        print(f'[39c data parallel W={world} NCCL] one rank a GPU, '
              f'b{DP_LOCAL} each: rank 0 {np.mean(ranks[0]["ms"][1:]):.2f} '
              f'ms/step ({ranks[0]["ms"][1:]}), all-reduce '
              f'{np.mean(ranks[0]["all_reduce_ms"][1:]):.2f} ms, peak '
              f'{ranks[0]["peak_gib"]:.2f} GiB; states bit-equal across '
              f'ranks; against one process: losses {loss_gap:.2e}, '
              f'parameters {param_gap:.3f} learning rates ({card})')
        check(loss_gap <= DP_LOSS_TOL
              and param_gap <= DP_PARAM_LR * (1 + N_TIMED),
              '39c is off the one-process run')
        for r, res in enumerate(ranks):
            check(res['launches'][-1] == (1 + N_TIMED, 1 + N_TIMED),
                  f'39c rank {r} launches {res["launches"]}')
            launches[f'w{world}_nccl_rank{r}'] = res['launches'][-1]
    _dp_torchrun(card)
    return launches


# Phase 40: the modules of the last bring-up slice.  MM_BF16_TOL bounds
# the bf16 multi-modal BEVFormer layer against its f32 run, as a share of
# max|f32| (the layer ends in a LayerNorm, so its outputs are O(1)).
CENTER_GT = 50
CENTER_VALID = 40
MM_BF16_TOL = 5e-2
CHAMFER_POINTS = 100_000
CHAMFER_SUBSET = 8000


@contextlib.contextmanager
def _no_host_sync():
    """Raise on any host sync inside the block."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode('default')


def _center_gt(rng, pc_range):
    """CENTER_GT padded boxes a sample, the first CENTER_VALID valid:
    centres inside the range (1 m margin), sizes 0.5-4 m, yaw over a
    turn, velocities up to 5 m/s, labels over 4 classes."""
    import torch

    x0, y0, z0, x1, y1, z1 = pc_range
    shape = (BATCH, CENTER_GT)
    boxes = np.stack([rng.uniform(x0 + 1, x1 - 1, shape),
                      rng.uniform(y0 + 1, y1 - 1, shape),
                      rng.uniform(z0, z1 - 4, shape),
                      *rng.uniform(0.5, 4.0, (3,) + shape),
                      rng.uniform(-np.pi, np.pi, shape),
                      *rng.uniform(-5, 5, (2,) + shape)], -1)
    labels = rng.randint(0, 4, shape)
    mask = np.zeros(shape, bool)
    mask[:, :CENTER_VALID] = True
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(labels), torch.from_numpy(mask))


def phase_center_head(dev, card, fcfg):
    """40a: the CenterPoint head on b4 fused BEVs of the shipped BEVFusion
    (its head's input width over the LSS grid)."""
    import copy

    import torch

    from omnihd_scenes_tpu_torch.models.centerpoint_head import (
        CenterHead, CenterTargetCfg, center_head_decode, center_head_loss)

    nx, ny, _ = fcfg.lss.bev_nx
    tcfg = CenterTargetCfg(pc_range=tuple(fcfg.lss.pc_range), out_hw=(ny, nx))
    torch.manual_seed(40)
    head = CenterHead(fcfg.head_channels, num_classes=4, share_channels=64,
                      head_channels=64).eval()
    bev = torch.randn(BATCH, fcfg.head_channels, ny, nx,
                      generator=torch.Generator().manual_seed(40))
    gt = _center_gt(np.random.RandomState(40), tcfg.pc_range)
    with torch.no_grad():
        ref = head(bev)
        ref_dec = center_head_decode(ref, tcfg, max_num=500)
    card_head = copy.deepcopy(head).to(dev)
    x = bev.to(dev)
    gt_d = [t.to(dev) for t in gt]
    with torch.no_grad(), _no_host_sync():
        out = card_head(x)
        dec = center_head_decode(out, tcfg, max_num=500)
    errs = {k: _share(out[k].cpu(), ref[k]) for k in ref}
    check(max(errs.values()) <= 1e-4, f'40a CenterHead card vs CPU {errs}')
    check(tuple(dec[0].shape) == (BATCH, 500, 9), f'decode {dec[0].shape}')
    dec = [t.cpu() for t in dec]
    kept = dec[3].sum(-1).tolist()
    check(kept == ref_dec[3].sum(-1).tolist(),
          f'40a kept rows {kept} on the card, {ref_dec[3].sum(-1).tolist()} '
          f'on the CPU')
    row_err = max(kept_row_distance(dec, ref_dec, s) for s in range(BATCH))
    check(row_err <= 1e-4, f'40a kept rows differ by {row_err}')
    card_head.train()
    torch.cuda.reset_peak_memory_stats(dev)
    with _no_host_sync():
        preds = card_head(x)
        losses = center_head_loss(preds, *gt_d, tcfg)
        total = (losses['loss_heatmap'] + losses['loss_bbox']).mean()
        total.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    grad = card_head.heatmap_out.weight.grad
    check(bool(torch.isfinite(total)) and grad is not None
          and bool(grad.abs().sum() > 0), '40a loss or gradient')
    card_head.eval()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: card_head(x), 10, 2)
        loss_ms = cuda_ms(lambda: center_head_loss(out, *gt_d, tcfg), 10, 2)
        dec_ms = cuda_ms(lambda: center_head_decode(out, tcfg, max_num=500),
                         10, 2)
    print(f'[40a CenterPoint] b{BATCH} {fcfg.head_channels}x{ny}x{nx} -> '
          f'4 classes, {CENTER_GT} GT a sample: card vs CPU f32 '
          f'{max(errs.values()):.2e} of max|ref| (bound 1e-4), kept rows '
          f'{kept} matched to the CPU\'s as multisets within {row_err:.1e} '
          f'(bound 1e-4); losses '
          f'{[round(float(v), 4) for v in losses["loss_heatmap"].detach()]} / '
          f'{[round(float(v), 4) for v in losses["loss_bbox"].detach()]}; forward '
          f'{fwd_ms:.3f} ms, targets + loss {loss_ms:.3f} ms, decode '
          f'{dec_ms:.3f} ms by CUDA events; train step peak {peak:.2f} GiB; '
          f'no host sync ({card})')


def phase_mm_bevformer(dev, card, c_pts):
    """40b: ``MMBEVFormerLayer`` at BEVFormer-T R50's widths with the
    shipped BEVFusion's radar BEV width."""
    import copy

    import torch

    from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
        BEVFormerLayer, MMBEVFormerLayer, get_reference_points_2d,
        get_reference_points_3d, point_sampling)
    from omnihd_scenes_tpu_torch.serve.synthetic import OFFSET_STD
    from omnihd_scenes_tpu_torch.utils.rig import ring_rig_lidar2img
    from omnihd_scenes_tpu_torch.weights import init_weights

    bcfg = _bevformer_cfg('configs/bevformer_t_r50.py')
    c, h, w, cams = bcfg.embed_dims, bcfg.bev_h, bcfg.bev_w, bcfg.num_cams
    nq = h * w
    cam_hw = tuple(-(-s // 32) for s in bcfg.img_hw)     # ResNet C5
    gen = torch.Generator().manual_seed(40)
    layer = init_weights(MMBEVFormerLayer(c_pts, c, num_cams=cams), gen)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith(('sampling_offsets.weight',
                              'attention_weights.weight')):
                p.copy_(torch.randn(p.shape, generator=gen) * OFFSET_STD)
        layer.fusion_w_cam.fill_(0.7)
        layer.fusion_w_pts.fill_(-0.4)
    layer.eval()
    pc = bcfg.pc_range
    ref_3d = torch.from_numpy(get_reference_points_3d(h, w, 4, pc[5] - pc[2]))
    l2i = torch.from_numpy(ring_rig_lidar2img(img_hw=bcfg.img_hw))[None]
    ref_cam, mask = point_sampling(ref_3d, pc, l2i, bcfg.img_hw)
    ref2d = torch.from_numpy(get_reference_points_2d(h, w))
    q, prev = (torch.randn(1, nq, c, generator=gen) for _ in range(2))
    inputs = {'query': q, 'pos': torch.randn(nq, c, generator=gen),
              'values': torch.stack([prev, q], 1),
              'ref_2d': torch.stack([ref2d + 0.01, ref2d])[None],
              'cam': torch.randn(1, cams, cam_hw[0] * cam_hw[1], c,
                                 generator=gen),
              'ref_cam': ref_cam, 'mask': mask,
              'lidar': torch.randn(1, nq, c_pts, generator=gen)}
    shapes = (((h, w),), (cam_hw,))

    def run(m, t, lidar=True):
        return m(t['query'], t['pos'], t['values'], t['ref_2d'], t['cam'],
                 t['ref_cam'], t['mask'], *shapes,
                 *((t['lidar'],) if lidar else ()))

    with torch.no_grad():
        ref = run(layer, inputs)
    card32 = copy.deepcopy(layer).to(dev)
    in32 = {k: v.to(dev) for k, v in inputs.items()}
    card16 = copy.deepcopy(card32).to(torch.bfloat16)
    in16 = {k: v.to(torch.bfloat16) if k not in ('ref_2d', 'ref_cam', 'mask')
            else v for k, v in in32.items()}
    with torch.no_grad():
        run(card32, in32)     # makes the per-device offset normaliser
        with _no_host_sync():
            got32 = run(card32, in32)
            got16 = run(card16, in16)
    err32, err16 = _share(got32.cpu(), ref), _share(got16, got32)
    check(err32 <= 1e-4, f'40b MM layer card f32 vs CPU {err32:.2e}')
    check(err16 <= MM_BF16_TOL, f'40b MM layer bf16 vs f32 {err16:.2e}')
    cam_only = BEVFormerLayer(c, num_cams=cams).to(dev)
    cam_only.load_state_dict({k: v for k, v in card32.state_dict().items()
                              if k in cam_only.state_dict()})
    cam16 = copy.deepcopy(cam_only).to(torch.bfloat16)
    with torch.no_grad():
        ms = {'mm_f32': cuda_ms(lambda: run(card32, in32), 5, 1),
              'mm_bf16': cuda_ms(lambda: run(card16, in16), 5, 1),
              'cam_f32': cuda_ms(lambda: run(cam_only, in32, False), 5, 1),
              'cam_bf16': cuda_ms(lambda: run(cam16, in16, False), 5, 1)}
    print(f'[40b MMBEVFormerLayer] {nq} queries x {c}, {cams} cameras of '
          f'{cam_hw[0]}x{cam_hw[1]}, radar BEV {c_pts} channels: card f32 vs '
          f'CPU {err32:.2e} of max|ref| (bound 1e-4), bf16 vs f32 '
          f'{err16:.2e} (bound {MM_BF16_TOL}); ms by CUDA events f32 / bf16 '
          f'{ms["mm_f32"]:.3f} / {ms["mm_bf16"]:.3f} against '
          f'BEVFormerLayer\'s {ms["cam_f32"]:.3f} / {ms["cam_bf16"]:.3f}; no '
          f'host sync ({card})')


def phase_chamfer(dev, card):
    """40c: chamfer between two 100k-point clouds on the card."""
    import torch

    from omnihd_scenes_tpu_torch.ops.chamfer import chamfer_distance

    gen = torch.Generator().manual_seed(40)
    scale = torch.tensor([50.0, 40.0, 4.0])
    a, b = ((torch.rand(CHAMFER_POINTS, 3, generator=gen) * 2 - 1) * scale
            for _ in range(2))
    sub = slice(0, CHAMFER_SUBSET)
    want = [float(t) for t in chamfer_distance(a[sub], b[sub])]
    a_d, b_d = a.to(dev), b.to(dev)
    with _no_host_sync():
        got_sub = chamfer_distance(a_d[sub], b_d[sub])
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        full = chamfer_distance(a_d, b_d)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        again = chamfer_distance(a_d, b_d, chunk=2048)
    rel = max(abs(float(g) - w) / w for g, w in zip(got_sub, want))
    check(rel <= 1e-6, f'40c chamfer card vs CPU {rel:.2e} relative')
    check(all(bool(x == y) for x, y in zip(full, again)),
          f'40c chamfer depends on the chunk: {full} vs {again}')
    ms = cuda_ms(lambda: chamfer_distance(a_d, b_d), 3, 1)
    print(f'[40c chamfer] {CHAMFER_POINTS} x {CHAMFER_POINTS} f32 points: '
          f'{[float(t) for t in full]} m^2, bit-equal at chunk 4096 and '
          f'2048; {CHAMFER_SUBSET}-point subset card vs CPU {rel:.2e} '
          f'relative (bound 1e-6); {ms:.2f} ms by CUDA events, peak '
          f'{peak:.3f} GiB above the clouds; no host sync ({card})')


def phase_get_flops(dev, card, cfg, model):
    """40d: ``tools/get_flops.py`` on the shipped BEVFusion (``cfg``, and
    ``model`` built from it), card and CPU.  Returns the LSS kernel's
    launches of the card's count."""
    from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
    from omnihd_scenes_tpu_torch.tools.get_flops import count

    lss_sample_bev.launches = 0
    t0 = time.perf_counter()
    on_card = count(cfg, dev)
    card_s = time.perf_counter() - t0
    launches = lss_sample_bev.launches
    t0 = time.perf_counter()
    on_cpu = count(cfg, 'cpu')
    cpu_s = time.perf_counter() - t0
    sd = model.state_dict()
    sd_params = sum(sd[k].numel() for k, _ in model.named_parameters())
    check(on_card['params'] == on_cpu['params'] == sd_params,
          f'40d params {on_card["params"]} / {on_cpu["params"]} / '
          f'state_dict {sd_params}')
    check(on_card['flops'] == on_cpu['flops'],
          f'40d FLOPs card {on_card["flops"]} vs CPU {on_cpu["flops"]}')
    check(launches == 1, f'40d LSS launches {launches}, not 1')
    print(f'[40d get_flops] configs/bevfusion.py b1: params '
          f'{on_card["params"]} (= the state_dict\'s parameters), forward '
          f'flops (convs, matmuls, LSS) {on_card["flops"] / 1e9:.2f} GFLOPs '
          f'on the card = the CPU\'s; lss_sample_bev launches {launches}; '
          f'{card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU ({card})')
    return launches


def phase_device_trace(dev, card, cfg, state_dict):
    """40e: ``device_trace`` around one b4 bf16 serving request.  Returns
    the LSS kernel's launches in the traced request."""
    import os
    import shutil
    import tempfile

    import torch

    from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from omnihd_scenes_tpu_torch.utils.timing import device_trace

    predictor = Predictor(cfg, state_dict, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(40)
    warm, request = (random_request(rng, cfg, BATCH) for _ in range(2))
    predictor(*warm)
    torch.cuda.synchronize()
    logdir = tempfile.mkdtemp(prefix='smoke_trace_')
    try:
        lss_sample_bev.launches = 0
        t0 = time.perf_counter()
        with device_trace(logdir):
            boxes = predictor(*request)[0]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lss_sample_bev.launches
        files = os.listdir(logdir)
        check(len(files) == 1, f'40e trace files {files}')
        path = os.path.join(logdir, files[0])
        size = os.path.getsize(path)
        events = json.load(open(path))['traceEvents']
    finally:
        shutil.rmtree(logdir)
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    lss = [k for k in kernels if 'lss_sample_kernel' in k]
    ops = {e['name'] for e in events if e.get('cat') == 'cpu_op'}
    check(size > 0 and len(lss) == 1 and 'omnihd::lss_sample_bev' in ops,
          f'40e trace of {size} bytes: LSS kernels {lss}, op present '
          f'{"omnihd::lss_sample_bev" in ops}')
    check(launches == 1 and bool(torch.isfinite(boxes).all()),
          f'40e LSS launches {launches}')
    print(f'[40e device_trace] one b{BATCH} bf16 request traced in '
          f'{wall:.1f} s (export included): {size / 2 ** 20:.1f} MiB, '
          f'{len(kernels)} kernel events, the LSS kernel '
          f'{re.search(r"lss_sample_kernel<[^(]*", lss[0]).group(0)[:80]!r} '
          f'once under '
          f'omnihd::lss_sample_bev; lss_sample_bev launches {launches} '
          f'({card})')
    return launches


def phase_remaining_modules(dev, card, cfg, state_dict):
    """Phase 40 -> the LSS kernel's launches in 40d and 40e."""
    import torch

    from omnihd_scenes_tpu_torch.train.builder import build_model_from_cfg
    from omnihd_scenes_tpu_torch.train.config import Config

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shipped = Config.fromfile('configs/bevfusion.py')
    model = build_model_from_cfg(shipped)[0]
    fcfg = model.cfg
    phase_center_head(dev, card, fcfg)
    phase_mm_bevformer(dev, card, sum(fcfg.pillars.fpn_channels))
    phase_chamfer(dev, card)
    launches = {'get_flops': phase_get_flops(dev, card, shipped, model),
                'device_trace': phase_device_trace(dev, card, cfg,
                                                   state_dict)}
    torch.cuda.empty_cache()
    print(f'[40 remaining modules] {time.perf_counter() - t0:.1f} s')
    return launches


def main():
    t_start = time.perf_counter()
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
    phase_mtl_small(dev)
    mtl = {'request': phase_mtl_serving(dev, card, bf16_ms)}
    mtl.update(_train_from_config(dev, card, 'configs/bevfusion_occ.py',
                                  '22 MTL train step'))
    rcf = phase_rcfusion(dev, card)
    phase_bevformer_small(dev)
    phase_bevformer_stream(dev, card)
    phase_bevformer_train_small(dev)
    bevformer_train = phase_bevformer_train(dev, card)
    phase_dcn_small(dev)
    r101 = phase_r101_stream(dev, card)
    aug_back, aug_fwd = phase_aug_train(dev, card)
    phase_host_feed(dev, card)
    phase_scatter_small(dev)
    scatter = phase_scatter(dev, card, cfg, state_dict, bf16_ms)
    train_sd = random_state_dict(BEVFusionConfig(), seed=0)
    _, (scatter['train_back'], scatter['train_fwd']) = phase_train(
        dev, card, BATCH, train_sd, cfg=_scatter_config(BEVFusionConfig()),
        label='29 scatter train step', per_step=(0, 0))
    fold = phase_dense_fold(dev, card, cfg, state_dict)
    s2d = phase_s2d(dev, card, cfg, state_dict, bf16_ms)
    remat = phase_remat(dev, card, train_sd)
    del train_sd
    mtl_int8 = phase_mtl_int8(dev, card)
    camera = phase_camera_dataroot(dev, card)
    cam_train = phase_camera_train(dev, card, train[BATCH][0])
    fuse = phase_fuse(dev, card)
    export = phase_export(dev, card, fuse.pop('cfg'), fuse.pop('fused'))
    qat = phase_qat(dev, card, cfg, state_dict)
    dp = phase_data_parallel(dev, card, train[BATCH][0])
    p40 = phase_remaining_modules(dev, card, cfg, state_dict)
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
            'bconv': ('bconv', b_launches, *b_row),
            # rectify: one b4 batch of phase 34, from the decoded planes
            # to the padded f32 images (library: one F.grid_sample of the
            # decoded f32 images on the chain's grid); launches of phase
            # 34's main path (1 a batch).
            'rectify': ('rectify', camera['launches']['rectify'],
                        *camera['rectify']),
            # jpeg_idct: the same batch's coefficients to planes (no
            # library call computes islow); 1 launch a batch.
            'jpeg_idct': ('jpeg_idct', camera['launches']['jpeg_idct'],
                          *camera['idct']),
            # rectify's setup kernels at the batch's shapes (the map, the
            # full-size cameras' geometry); launches of phase 34's main
            # path (1 a map, 1 a map geometry for both tables, at their
            # first use).
            **{name: ('rectify', camera['launches'][name],
                      *camera['setup'][name]) for name in SETUP_KERNELS},
            # The training augmentations (phase 35a: one decoded b4 batch,
            # 24 x 544x960; library: F.interpolate of the crops for
            # crop_resize_flip, none for photometric); launches of phase
            # 35b's training run (1 a step).
            **{name: (name, cam_train['launches'][name], *cam_train[name])
               for name in AUG_KERNELS}}
    # Launches on the LSS camera-only path (phase 18), BEVFusion-OCC
    # (phases 21-22) and RCFusion (phase 23): each b4 training run (1 +
    # N_TIMED steps) and each path's first b4 request.
    paths = {'launches_lss_camera': dict(cam, request=cam['infer']),
             'launches_mtl': mtl, 'launches_rcfusion': rcf}
    extra = {name: {} for name in rows}
    for key, p in paths.items():
        extra['lss_sample'][key] = {'train_b4': p['train_fwd'],
                                    'request_b4': p['request']}
        extra['lss_sample_backward'][key] = {'train_b4': p['train_back']}
    extra['lss_sample']['launches_aug_train'] = {'train_b4': aug_fwd}
    extra['lss_sample_backward']['launches_aug_train'] = {
        'train_b4': aug_back}
    # Phases 29-33: the scatter path launches no LSS kernel; remat
    # launches the LSS forward twice a step (forward and recomputation).
    extra['lss_sample']['launches_scatter'] = {
        'request_b4': scatter['request'], 'train_b4': scatter['train_fwd']}
    extra['lss_sample_backward']['launches_scatter'] = {
        'train_b4': scatter['train_back']}
    extra['lss_sample']['launches_dense_fold'] = {'request_b4': fold}
    extra['lss_sample']['launches_s2d'] = {
        'request_b4': s2d['request_b4'],
        'int8_request_b4': s2d['int8_request_b4']}
    extra['qconv']['launches_s2d'] = {
        'int8_request_b4': s2d['qconv_int8_request_b4']}
    extra['lss_sample']['launches_remat_train'] = {
        'train_b4': remat['train_fwd']}
    extra['lss_sample_backward']['launches_remat_train'] = {
        'train_b4': remat['train_back']}
    extra['lss_sample']['launches_mtl_int8'] = {
        'request_b4': mtl_int8['request']}
    extra['qconv']['launches_mtl_int8'] = {
        'request_b4': mtl_int8['qconv_request']}
    check(scatter['request'] == scatter['train_fwd']
          == scatter['train_back'] == 0,
          'the scatter path launched an LSS kernel')
    # BEVFormer-T's training run (phase 25b) and R101-DCN's stream (26b)
    # launch no hand kernel: their paths hold none.
    for name in _kernel_launches():
        extra[name]['launches_bevformer_train'] = \
            bevformer_train['launches'][name]
        extra[name]['launches_r101_dcn_stream'] = r101['launches'][name]
    from omnihd_scenes_tpu_torch.kernels._build import SOURCES

    # Phase 35b's camera training run: every kernel of its path once a
    # step (the decode's, the augmentations', the LSS forward and
    # backward), rectify's setup kernels at first use.
    for name in _kernel_launches():
        extra[name]['launches_camera_train'] = cam_train['launches'][name]
    extra['rectify'].update(camera['rectify_extra'])
    # No PyTorch call computes libjpeg's islow: the IDCT row has no
    # library time; nvJPEG's batched decode (Huffman + its own IDCT) is
    # the decode's yardstick, under its own key.
    extra['jpeg_idct']['library'] = 'none'
    extra['jpeg_idct']['nvjpeg_decode'] = ('nvJPEG nvjpegDecodeBatched of '
                                           'the same JPEGs')
    for name in ('rectify_footprint', 'rectify_taps'):
        extra[name]['one_launch'] = (
            'geometry_tables_kernel makes the footprint and taps tables: '
            'launches, ms, plain_ms and bound_ms are that launch\'s')
    extra['jpeg_idct']['fixture_max_abs_err'] = camera['jpeg_max']
    extra['jpeg_idct'].update(camera['host'])
    extra['jpeg_idct']['launches_jpeg_decode'] = \
        camera['launches']['jpeg_decode']
    extra['jpeg_idct']['launches_nvjpeg_decode'] = \
        camera['launches']['nvjpeg_decode']
    # Phases 36-38: the fused checkpoint served (one LSS launch a
    # request), the exported program in its own process (the registered
    # op, one launch a request: 1 + 3 requests), QAT training (one
    # forward and one backward a step) and its int8 serving.
    extra['lss_sample']['launches_fused'] = {'request_b4': fuse['request']}
    extra['lss_sample']['launches_exported_program'] = {
        'requests_b4': 1 + N_TIMED, 'launches': export['launches']}
    extra['lss_sample']['launches_qat_train'] = {'train_b4': qat['train_fwd']}
    extra['lss_sample_backward']['launches_qat_train'] = {
        'train_b4': qat['train_back']}
    extra['lss_sample']['launches_qat_int8'] = {
        'request_b4': qat['lss_request']}
    extra['qconv']['launches_qat_int8'] = {'request_b4': qat['qconv_request']}
    # Phase 39: each rank's LSS forward and backward launches over its
    # 1 + N_TIMED data-parallel steps (one each a step).
    extra['lss_sample']['launches_data_parallel'] = {
        run: fwd for run, (fwd, _) in dp.items()}
    extra['lss_sample_backward']['launches_data_parallel'] = {
        run: back for run, (_, back) in dp.items()}
    # Phase 40: the b1 forward that get_flops counts on the card and the
    # b4 bf16 request traced by device_trace, one launch each.
    extra['lss_sample']['launches_get_flops'] = {
        'forward_b1': p40['get_flops']}
    extra['lss_sample']['launches_device_trace'] = {
        'request_b4': p40['device_trace']}
    print(f'[wall] chip_smoke.py {time.perf_counter() - t_start:.1f} s to '
          f'the kernels line ({card})')
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'{CSRC}{SOURCES.get(src, src + ".cu")}',
        'replaces': KERNEL_REPLACES[name][0],
        **({'also_replaces': KERNEL_REPLACES[name][1]}
           if len(KERNEL_REPLACES[name]) > 1 else {}),
        'launches': n, 'max_abs_err': e, 'ms': t, 'plain_ms': pt,
        'bound_ms': bt, 'bound_by': by, 'library_ms': lib,
        **extra.get(name, {})}
        for name, (src, n, e, t, pt, bt, by, lib) in rows.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
