"""The CUDA kernels (LSS sampling, int8 and bf16 3x3 convolution) against
their plain PyTorch versions, on the card, and small train steps (BEVFusion,
with the scatter splat and with remat too, the camera-only model,
BEVFusion-OCC in each trunk mode, RCFusion, the pillar families) and
small serving runs (BN-folded pillars, the space-to-depth stem, the
scatter splat) on the card against the CPU; the registered LSS ops, a
fused checkpoint served and a bundle exported on the card; a
data-parallel step of two ranks on the card over gloo.  Every test
here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

Bounds:
* lss_sample and lss_sample_bev, f32 outputs: 1e-5 * max|ref| + 1e-6
  (the kernel rounds products and sums separately and sums the cameras
  in order, as the plain version does, so it is usually exact); the
  fused kernel's indices identical to the plain fields on the card.
* lss_sample_bev_backward: the kernel sums each pixel's (cell, camera)
  pairs in increasing cell order, the order of the plain ``index_add_``
  on the CPU, so its d feat (f32 sums, then one rounding to feat's dtype)
  is bit-equal to the plain version run on the CPU on the card's indices;
  its d depth reduces each dot product in another order than ``.sum(-1)``:
  within 1e-5 * max|ref|, plus 1 bf16 ulp of the reference in bf16.  Two
  launches give identical bits.  The plain version on the card adds with
  CUDA atomics in a changing order: the kernel is within that same
  tolerance of it.
* a small f32 train step on the card against the same step on the CPU
  (TF32 off), every BatchNorm in train mode with its bias at +4 so that
  no ReLU input sits within a rounding of 0 (where it would take the
  other branch on the other device): the loss within 1e-5 relative, the
  whole gradient within 1e-4 in relative L2 norm, the new BatchNorm
  statistics within 1e-4 of max|ref|, the parameters after AdamW within
  2.5 learning rates.
* rectify (camera decode, planes to padded f32 images in one launch, and
  its setup kernels: packed map; tile footprints and resize taps, both
  from one launch a map and geometry): bit-equal to its plain version on
  the card (integer steps, then f32 steps rounded alike; the plain
  version emulates the FMA exactly).
* jpeg_idct: bit-equal to its plain version (32-bit words that wrap
  alike), on the fixtures' coefficients and on extreme random blocks,
  over odd block grids, the kernel's chunk edges and the b4 batch's
  layout.
* the card's JPEG decode (host entropy decode, the IDCT kernel, libjpeg's
  upsampling and colour tables in the rectify kernel) against the
  committed ``cv2.imdecode`` results of ``tests/torch_port_fixtures/
  jpeg``: exact, max |diff| 0.
The conv cases include the edge shapes of the kernels' block tiling
(images smaller than a 128-pixel tile, widths that split tiles, channel
counts that are not multiples of the block's channel tile).

* qconv3x3: the integer sum is exact in both versions and the epilogue
  rounds the same steps, so f32 outputs within 2^-22 |ref| (one f32
  rounding) and bf16 outputs within 1 ulp on under 1e-3 of the entries
  (``tests/test_qconv.py``'s bound).
* bconv3x3: both sum in f32 in different orders, so the bf16 output is
  within 1 bf16 ulp of the plain f32 result rounded, plus 1e-5 *
  max|ref| for cancellation near zero.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omnihd_scenes_tpu_torch.utils.rig import (perturbed_rigs,
                                               ring_rig_img2lidar)
from omnihd_scenes_tpu_torch.kernels.bconv import bconv3x3
from omnihd_scenes_tpu_torch.kernels.lss_sample import (
    LSSSampleBEV, cell_indices, geometry_fields, lss_sample, lss_sample_bev,
    lss_sample_bev_backward, lss_sample_bev_backward_reference,
    lss_sample_bev_reference, lss_sample_reference, scatter_cells)
from omnihd_scenes_tpu_torch.kernels.qconv import (qconv3x3,
                                                   qconv3x3_reference)
from omnihd_scenes_tpu_torch.models.quant import (QConv2d, quant_state,
                                                  load_quant_state, set_mode)
from omnihd_scenes_tpu_torch.ops.lss_project import (_Geom, camera_geometry,
                                                     sample_fields)

pytestmark = pytest.mark.gpu

IMG_HW = (128, 224)
FEAT_HW = (32, 56)
DEPTH_RANGE = (1.0, 30.0, 1.0)
D = 29
BEV_NX = (48, 32, 4)                        # (nx, ny, nz)
SOLVE_X = (True, False, False, True, False, False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _case(dev, batch, dtype, seed=0, channels=64):
    g = _Geom(IMG_HW, FEAT_HW, DEPTH_RANGE, (-24.0, -16.0, -3.0),
              (1.0, 1.0, 2.0), BEV_NX)
    rots, trans = ring_rig_img2lidar(img_hw=IMG_HW)
    rots = torch.from_numpy(rots).to(dev).expand(batch, -1, -1, -1)
    trans = torch.from_numpy(trans).to(dev).expand(batch, -1, -1)
    fields = sample_fields(rots, trans, g, SOLVE_X)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, len(SOLVE_X)) + FEAT_HW
    feat = torch.randn(shape + (channels,), generator=gen, device=dev)
    depth = torch.softmax(torch.randn(shape + (D,), generator=gen,
                                      device=dev), -1)
    return g, feat.to(dtype), depth.to(dtype), fields


def _check(got, want):
    tol = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got.float() - want).abs().max()) <= tol
    assert torch.equal(got.ne(0).any(-1), want.ne(0).any(-1))


@pytest.mark.parametrize('in_dtype,out_dtype', [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('batch', [1, 3])
def test_kernel_matches_plain(dev, batch, in_dtype, out_dtype):
    g, feat, depth, fields = _case(dev, batch, in_dtype)
    before = lss_sample.launches
    got = lss_sample(feat, depth, *fields, solve_x=SOLVE_X, ny=g.ny,
                     nx=g.nx, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert lss_sample.launches == before + 1
    assert got.shape == (batch, g.ny, g.nx, g.nz, 64)
    assert got.dtype == out_dtype
    want = lss_sample_reference(feat, depth, *fields, SOLVE_X, g.ny, g.nx,
                                torch.float32)
    assert want.ne(0).any(-1).float().mean() > 0.3, 'degenerate rig'
    if out_dtype == torch.bfloat16:
        want = want.to(torch.bfloat16).float()
    _check(got, want)


@pytest.mark.parametrize('channels', [2, 66, 256])
def test_channel_counts(dev, channels):
    g, feat, depth, fields = _case(dev, 2, torch.bfloat16, seed=1,
                                   channels=channels)
    got = lss_sample(feat, depth, *fields, solve_x=SOLVE_X, ny=g.ny,
                     nx=g.nx, out_dtype=torch.float32)
    _check(got, lss_sample_reference(feat, depth, *fields, SOLVE_X, g.ny,
                                     g.nx, torch.float32))


def test_out_of_range_depth_bins(dev):
    g, feat, depth, fields = _case(dev, 2, torch.bfloat16, seed=2)
    kd = fields.kd_star.clone()
    live = torch.nonzero((kd >= 0).flatten())[:, 0]
    kd.view(-1)[live[::3]] = D + 5
    kd.view(-1)[live[1::3]] = -1
    args = (feat, depth, fields.i_star, fields.j_star, kd)
    got = lss_sample(*args, solve_x=SOLVE_X, ny=g.ny, nx=g.nx,
                     out_dtype=torch.float32)
    _check(got, lss_sample_reference(*args, SOLVE_X, g.ny, g.nx,
                                     torch.float32))


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g, feat, depth, fields = _case(dev, 1, torch.bfloat16)
    kw = dict(solve_x=SOLVE_X, ny=g.ny, nx=g.nx)
    with pytest.raises(TypeError):
        lss_sample(feat.half(), depth.half(), *fields, **kw)
    with pytest.raises(TypeError):
        lss_sample(feat.float(), depth.float(), *fields,
                   out_dtype=torch.bfloat16, **kw)
    with pytest.raises(TypeError):
        lss_sample(feat, depth, fields.i_star.long(), fields.j_star,
                   fields.kd_star, **kw)
    with pytest.raises(ValueError, match='contiguous'):
        lss_sample(feat.transpose(2, 3).contiguous().transpose(2, 3), depth,
                   *fields, **kw)
    with pytest.raises(ValueError, match='device'):
        lss_sample(feat, depth.cpu(), *fields, **kw)


def _bev_case(dev, batch, dtype, seed=0, channels=64, moved=True):
    """Geometry-in inputs: the ring rig, moved per sample and camera
    (``moved``) or the same for every sample."""
    g = _Geom(IMG_HW, FEAT_HW, DEPTH_RANGE, (-24.0, -16.0, -3.0),
              (1.0, 1.0, 2.0), BEV_NX)
    rots, trans = ring_rig_img2lidar(img_hw=IMG_HW)
    if moved:
        rots, trans = perturbed_rigs(rots, trans, batch, seed)
    else:
        rots, trans = (a[None].repeat(batch, 0) for a in (rots, trans))
    minv, mt = camera_geometry(torch.from_numpy(rots).to(dev),
                               torch.from_numpy(trans).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, len(SOLVE_X)) + FEAT_HW
    feat = torch.randn(shape + (channels,), generator=gen, device=dev)
    depth = torch.softmax(torch.randn(shape + (D,), generator=gen,
                                      device=dev), -1)
    return (g, feat.to(dtype), depth.to(dtype), minv.contiguous(),
            mt.contiguous())


@pytest.mark.parametrize('in_dtype,out_dtype', [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('batch', [1, 3])
def test_fused_kernel_matches_plain(dev, batch, in_dtype, out_dtype):
    g, feat, depth, minv, mt = _bev_case(dev, batch, in_dtype, seed=batch)
    before = (lss_sample_bev.launches, lss_sample.launches)
    got = lss_sample_bev(feat, depth, minv, mt, g, SOLVE_X,
                         out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (lss_sample_bev.launches, lss_sample.launches) == (before[0] + 1,
                                                              before[1])
    assert got.shape == (batch, g.ny, g.nx, g.nz, 64)
    assert got.dtype == out_dtype
    want = lss_sample_bev_reference(feat, depth, minv, mt, g, SOLVE_X,
                                    torch.float32)
    assert want.ne(0).any(-1).float().mean() > 0.3, 'degenerate rig'
    if out_dtype == torch.bfloat16:
        want = want.to(torch.bfloat16).float()
    _check(got, want)


@pytest.mark.parametrize('channels', [2, 66, 256])
@pytest.mark.parametrize('in_dtype', [torch.bfloat16, torch.float32])
def test_fused_channel_counts(dev, channels, in_dtype):
    g, feat, depth, minv, mt = _bev_case(dev, 2, in_dtype, seed=4,
                                         channels=channels)
    got = lss_sample_bev(feat, depth, minv, mt, g, SOLVE_X,
                         out_dtype=torch.float32)
    _check(got, lss_sample_bev_reference(feat, depth, minv, mt, g, SOLVE_X,
                                         torch.float32))


@pytest.mark.parametrize('moved', [False, True], ids=['ring', 'moved'])
def test_fused_indices_equal_the_plain_fields(dev, moved):
    """The (j, i, kd) that the dumping instance wrote, for every cell and
    camera, against the plain fields computed on the card."""
    g, feat, depth, minv, mt = _bev_case(dev, 3, torch.bfloat16, seed=5,
                                         moved=moved)
    out, idx = lss_sample_bev(feat, depth, minv, mt, g, SOLVE_X,
                              out_dtype=torch.float32, dump=True)
    want = cell_indices(*geometry_fields(minv, mt, g, SOLVE_X), SOLVE_X,
                        g.ny, g.nx, D)
    for name, a, b in zip('jik', idx, want):
        assert a.shape == b.shape == (3, g.ny, g.nx, g.nz, len(SOLVE_X))
        assert int((a != b).sum()) == 0, name
    assert int((idx[1] >= 0).sum()) > 1000
    assert torch.equal(out, lss_sample_bev(feat, depth, minv, mt, g,
                                           SOLVE_X, out_dtype=torch.float32))


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g, feat, depth, minv, mt = _bev_case(dev, 1, torch.bfloat16)
    before = lss_sample_bev.launches
    with pytest.raises(TypeError):
        lss_sample_bev(feat.half(), depth.half(), minv, mt, g, SOLVE_X)
    with pytest.raises(TypeError):
        lss_sample_bev(feat.float(), depth.float(), minv, mt, g, SOLVE_X,
                       out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='contiguous'):
        lss_sample_bev(feat, depth, minv.transpose(2, 3), mt, g, SOLVE_X)
    with pytest.raises(ValueError, match='device'):
        lss_sample_bev(feat, depth, minv.cpu(), mt, g, SOLVE_X)
    with pytest.raises(ValueError, match='even C'):
        lss_sample_bev(feat[..., :3].contiguous(), depth, minv, mt, g,
                       SOLVE_X)
    assert lss_sample_bev.launches == before


def _grad_case(dev, batch, dtype, seed, channels=64, moved=True):
    g, feat, depth, minv, mt = _bev_case(dev, batch, dtype, seed, channels,
                                         moved)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    grad = torch.randn((batch, g.ny, g.nx, g.nz, channels), generator=gen,
                       device=dev).to(dtype)
    return grad, feat, depth, minv, mt, g


def _check_backward(got, want, exact_dfeat=False):
    """f32: 1e-5 max|ref|; bf16: 1 ulp of the reference plus that; with
    ``exact_dfeat``, d feat bit-equal."""
    if exact_dfeat:
        assert torch.equal(got[0].cpu(), want[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float().cpu(), b.float().cpu()
        slack = 1e-5 * float(b.abs().max())
        if got[0].dtype == torch.bfloat16:
            _, exp = torch.frexp(b)
            slack = slack + torch.ldexp(torch.ones_like(b), exp - 8)
        assert bool(((a - b).abs() <= slack).all())


def _plain_on_the_cpu(grad, feat, depth, minv, mt, g):
    """The plain scatter run on the CPU (``index_add_`` in index order) on
    the indices computed on the card."""
    idx = cell_indices(*geometry_fields(minv, mt, g, SOLVE_X), SOLVE_X,
                       g.ny, g.nx, depth.shape[-1])
    return scatter_cells(grad.cpu(), feat.cpu(), depth.cpu(),
                         *(t.cpu() for t in idx))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('moved', [False, True], ids=['ring', 'moved'])
@pytest.mark.parametrize('batch', [1, 3])
def test_backward_kernel_matches_plain(dev, batch, moved, dtype):
    args = _grad_case(dev, batch, dtype, seed=batch + 7, moved=moved)
    before = lss_sample_bev_backward.launches
    got = lss_sample_bev_backward(*args, SOLVE_X)
    torch.cuda.synchronize()
    assert lss_sample_bev_backward.launches == before + 1
    want = lss_sample_bev_backward_reference(*args, SOLVE_X)
    assert float(want[0].float().abs().max()) > 0
    _check_backward(got, want)


@pytest.mark.parametrize('channels', [2, 66, 256])
def test_backward_channel_counts(dev, channels):
    args = _grad_case(dev, 2, torch.float32, seed=3, channels=channels)
    _check_backward(lss_sample_bev_backward(*args, SOLVE_X),
                    lss_sample_bev_backward_reference(*args, SOLVE_X))
    _check_backward(lss_sample_bev_backward(*args, SOLVE_X),
                    _plain_on_the_cpu(*args), exact_dfeat=True)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('moved', [False, True], ids=['ring', 'moved'])
def test_backward_is_deterministic_and_in_the_plain_order(dev, moved, dtype):
    """Two launches bitwise equal; d feat bit-equal to the plain scatter on
    the CPU (same order of sums), d depth within its tolerance."""
    args = _grad_case(dev, 2, dtype, seed=21, moved=moved)
    got = lss_sample_bev_backward(*args, SOLVE_X)
    again = lss_sample_bev_backward(*args, SOLVE_X)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = _plain_on_the_cpu(*args)
    assert float(want[0].float().abs().max()) > 0
    _check_backward(got, want, exact_dfeat=True)


# (feature map, BEV grid (nx, ny, nz), voxel, least longest bucket): 4x8
# features collect 64 pairs or more in a pixel; one pixel per camera on a
# 96x64x8 grid over 1,024.
LONG_BUCKETS = {'long': ((4, 8), BEV_NX, (1.0, 1.0, 2.0), 64),
                'one-pixel-cameras': ((1, 1), (96, 64, 8), (0.5, 0.5, 1.0),
                                      1025)}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('case', list(LONG_BUCKETS))
def test_backward_long_buckets(dev, case, dtype):
    """Pixels whose buckets hold many pairs, summed in cell order all the
    same."""
    feat_hw, bev_nx, voxel, longest = LONG_BUCKETS[case]
    g = _Geom(IMG_HW, feat_hw, DEPTH_RANGE, (-24.0, -16.0, -3.0), voxel,
              bev_nx)
    rots, trans = perturbed_rigs(*ring_rig_img2lidar(img_hw=IMG_HW), 2, 3)
    minv, mt = (t.contiguous() for t in camera_geometry(
        torch.from_numpy(rots).to(dev), torch.from_numpy(trans).to(dev)))
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (2, len(SOLVE_X)) + feat_hw
    feat = torch.randn(shape + (64,), generator=gen, device=dev).to(dtype)
    depth = torch.softmax(torch.randn(shape + (D,), generator=gen,
                                      device=dev), -1).to(dtype)
    grad = torch.randn((2, g.ny, g.nx, g.nz, 64), generator=gen,
                       device=dev).to(dtype)
    j, i, kd = cell_indices(*geometry_fields(minv, mt, g, SOLVE_X), SOLVE_X,
                            g.ny, g.nx, D)
    f_h, f_w = feat_hw
    ok = (j >= 0) & (j < f_h) & (i >= 0) & (i < f_w) & (kd >= 0) & (kd < D)
    n = torch.arange(len(SOLVE_X), device=dev).expand_as(j)
    b = torch.arange(2, device=dev).view(2, 1, 1, 1, 1).expand_as(j)
    pix = (((b * len(SOLVE_X) + n) * f_h + j) * f_w + i)[ok]
    assert int(torch.bincount(pix.long()).max()) >= longest
    args = (grad, feat, depth, minv, mt, g)
    got = lss_sample_bev_backward(*args, SOLVE_X)
    assert torch.equal(got[0], lss_sample_bev_backward(*args, SOLVE_X)[0])
    _check_backward(got, _plain_on_the_cpu(*args), exact_dfeat=True)


def test_function_launches_once_each_way(dev):
    """``LSSSampleBEV`` on card tensors: one forward and one backward
    launch, the geometry without a gradient."""
    grad, feat, depth, minv, mt, g = _grad_case(dev, 2, torch.bfloat16,
                                                seed=11)
    f, d = feat.clone().requires_grad_(), depth.clone().requires_grad_()
    before = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    out = LSSSampleBEV.apply(f, d, minv, mt, g, SOLVE_X)
    out.backward(grad)
    torch.cuda.synchronize()
    assert (lss_sample_bev.launches, lss_sample_bev_backward.launches) == (
        before[0] + 1, before[1] + 1)
    _check_backward((f.grad, d.grad), lss_sample_bev_backward_reference(
        grad, feat, depth, minv, mt, g, SOLVE_X))


def test_backward_refuses_what_the_kernel_does_not_take(dev):
    grad, feat, depth, minv, mt, g = _grad_case(dev, 1, torch.float32,
                                                seed=2)
    before = lss_sample_bev_backward.launches
    with pytest.raises(TypeError):           # (f32 in, bf16 grad)
        lss_sample_bev_backward(grad.to(torch.bfloat16), feat, depth, minv,
                                mt, g, SOLVE_X)
    with pytest.raises(TypeError):           # (bf16 in, f32 grad)
        lss_sample_bev_backward(grad, feat.to(torch.bfloat16),
                                depth.to(torch.bfloat16), minv, mt, g,
                                SOLVE_X)
    with pytest.raises(ValueError, match='contiguous'):
        lss_sample_bev_backward(grad.transpose(1, 2).contiguous().transpose(
            1, 2), feat, depth, minv, mt, g, SOLVE_X)
    with pytest.raises(ValueError, match='device'):
        lss_sample_bev_backward(grad.cpu(), feat, depth, minv, mt, g,
                                SOLVE_X)
    assert lss_sample_bev_backward.launches == before


def _small_train_case(seed, camera_only=False):
    import numpy as np

    from omnihd_scenes_tpu_torch import config as c
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                         random_train_batch)

    pc_range = (-8.0, -8.0, -3.0, 8.0, 8.0, 5.0)
    cfg = c.BEVFusionConfig(
        frozen_backbone_bn=False, radar_stream=not camera_only,
        lc_fusion=not camera_only, se=not camera_only,
        lss=c.LSSConfig(final_dim=(64, 112),
                        camera_depth_range=(1.0, 9.0, 1.0),
                        pc_range=pc_range, grid=2.0),
        pillars=c.PointPillarsConfig(
            point_cloud_range=pc_range, voxel_size=(1.0, 1.0, 8.0),
            max_voxels=256, max_points_per_voxel=8, bev_hw=(16, 16),
            anchor_ranges=tuple((-8.0, -8.0, z, 8.0, 8.0, z)
                                for z in (0.91, 1.142, 0.906, 1.516))))
    sd = random_state_dict(cfg, seed)
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'bias'] += 4.0
    batch = random_train_batch(np.random.RandomState(seed), cfg, 2,
                               n_points=600, max_gt=8)
    batch['gt_boxes'][..., :2] /= 5
    if camera_only:
        del batch['points'], batch['points_mask']
    return cfg, sd, batch


def test_data_parallel_step_on_two_ranks(dev, tmp_path):
    """``chip_smoke.py`` phase 39b at small size: two ranks on one card
    over gloo, one sample each, one f32 step (TF32 off) against the
    one-process step on both samples on the card, phase 14's bounds (the
    loss within 1e-5, the gradient after the reduction within 1e-4 in
    relative L2, the BatchNorm statistics within 1e-4 of max|ref|, the
    parameters within 2.5 learning rates); both ranks end bit-equal, each
    launching the LSS forward and backward kernels once."""
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic

    # By path: another installed package may own the name ``tests``.
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    'torch_port_fixtures'))
    from dp_worker import run_ranks, train_step_record

    cfg, sd, batch = _small_train_case(seed=9)
    lr = 1e-3
    r0, r1 = (r['card_step'] for r in run_ranks(
        {'card_step': {'cfg': cfg, 'state_dict': sd, 'batch': batch,
                       'lr': lr}}, str(tmp_path), timeout=300))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = BEVFusion(cfg)
    model.load_state_dict(sd)
    model.to(dev)
    one = train_step_record(model, make_loss_fn_generic(
        model, 'bevfusion', cfg.pillars.anchors(),
        camera_depth_range=cfg.lss.camera_depth_range), batch, lr)
    assert r0['digest'] == r1['digest'] and r0['loss'] == r1['loss']
    assert r0['launches'] == r1['launches'] == (1, 1)
    assert abs(r0['loss'] - one['scalars']['loss']) <= 1e-5 * abs(
        one['scalars']['loss'])
    want = {k: g.cpu() for k, g in one['grads'].items()}
    diff = sum(float((r0['grads'][k] - w).square().sum())
               for k, w in want.items())
    assert (diff / sum(float(w.square().sum()) for w in want.values())
            ) ** 0.5 <= 1e-4
    for k, w in one['state'].items():
        w = w.cpu()
        if not w.is_floating_point():
            assert torch.equal(r0['state'][k], w), k
        elif 'running' in k:
            assert float((r0['state'][k] - w).abs().max()) <= 1e-4 * float(
                w.abs().max()), k
        else:
            assert float((r0['state'][k] - w).abs().max()) <= 2.5 * lr, k


def _small_mtl_case(seed, mode, rc_fusion='concat'):
    """``_small_train_case``'s model at a 16x16 BEV (1 m cells, so the
    task trunks' stride-8 stage keeps 2x2 cells) as BEVFusion-OCC with
    ``trunk_mode=mode`` (``mode`` None: the fusion model alone, with
    ``rc_fusion``), and its batch with occupancy GT."""
    import dataclasses

    import numpy as np

    from omnihd_scenes_tpu_torch import config as c
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                         random_train_batch)

    base, _, _ = _small_train_case(seed)
    cfg = dataclasses.replace(
        base, rc_fusion=rc_fusion,
        lss=dataclasses.replace(base.lss, grid=1.0),
        pillars=dataclasses.replace(base.pillars, voxel_size=(0.5, 0.5, 8.0),
                                    bev_hw=(32, 32), max_voxels=512))
    if mode is not None:
        cfg = c.MTLConfig(fusion=cfg, occ_dz=4, trunk_mode=mode)
    sd = random_state_dict(cfg, seed)
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'bias'] += 4.0
    batch = random_train_batch(np.random.RandomState(seed), cfg, 2,
                               n_points=600, max_gt=8)
    batch['gt_boxes'][..., :2] /= 5
    return cfg, sd, batch


@pytest.mark.parametrize('mode', ['none', 'per_task', 'shared'])
def test_mtl_train_step_matches_the_cpu(dev, mode):
    """BEVFusion-OCC in each trunk mode, occupancy losses included: the
    same bounds, one LSS forward and one backward launch on the card."""
    _train_step_on_both(dev, *_small_mtl_case(4, mode), 'bevfusion_mtl')


def test_rcfusion_train_step_matches_the_cpu(dev):
    _train_step_on_both(dev, *_small_mtl_case(5, None, 'cross_attention'),
                        'rcfusion')


def test_small_train_step_matches_the_cpu(dev):
    _train_step_on_both(dev, *_small_train_case(seed=1), 'bevfusion')


def test_lss_camera_only_train_step_matches_the_cpu(dev):
    """The camera-only model (no radar stream, no fusion, no SE): the same
    bounds, and one LSS forward and one backward launch on the card."""
    _train_step_on_both(dev, *_small_train_case(seed=2, camera_only=True),
                        'lss')


def test_scatter_train_step_matches_the_cpu(dev):
    """The scatter view transform (``splat_mode='scatter'``: ``index_add_``,
    atomics on the card): the same bounds, and no LSS kernel launch."""
    import dataclasses

    cfg, sd, batch = _small_train_case(seed=6)
    cfg = dataclasses.replace(cfg, lss=dataclasses.replace(
        cfg.lss, splat_mode='scatter'))
    _train_step_on_both(dev, cfg, sd, batch, 'bevfusion', expect=(0, 0))


def test_remat_train_step_matches_the_cpu(dev):
    """Every trunk rematerialised: the same bounds; the LSS forward kernel
    runs again when the backward recomputes the LSS trunk."""
    import dataclasses

    cfg, sd, batch = _small_train_case(seed=7)
    _train_step_on_both(dev, dataclasses.replace(cfg, remat=True), sd, batch,
                        'bevfusion', expect=(2, 1))


@pytest.mark.parametrize('option', ['dense_fold', 'stem_s2d', 'scatter'])
def test_serving_options_on_the_card_equal_the_cpu(dev, option):
    """f32 ``Predictor`` network outputs on the card within 1e-4 of
    max|ref| of the CPU's (TF32 off), for the BN-folded pillars, the
    space-to-depth stem (packed images) and the scatter splat."""
    import dataclasses

    import numpy as np

    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sd, _ = _small_train_case(seed=8)
    change = {'dense_fold': dict(pillars=dataclasses.replace(
                  cfg.pillars, pillar_impl='dense_fold')),
              'stem_s2d': dict(stem_s2d=True),
              'scatter': dict(lss=dataclasses.replace(
                  cfg.lss, splat_mode='scatter'))}[option]
    cfg = dataclasses.replace(cfg, **change)
    request = random_request(np.random.RandomState(8), cfg, 2, 600)
    outs = [Predictor(cfg, sd, device=d, dtype=torch.float32).forward(
        *request) for d in ('cpu', dev)]
    for key in ('bev', 'cls_score', 'bbox_pred', 'dir_pred'):
        want, got = outs[0][key], outs[1][key].cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), key


def test_pillar_families_on_the_card_equal_the_cpu(dev):
    """PointPillars radar (sorted, dense), RadarPillarNet and LiDAR at a
    small size: ``chip_smoke.py`` phase 16's checks (head maps within
    1e-4 of max|ref|, the same kept rows, one train step's loss within
    1e-5 and gradient within 1e-4)."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_pillars_small(dev)


def _train_step_on_both(dev, cfg, sd, batch, mtype, expect=(1, 1)):
    """One step on the CPU and on the card; ``expect`` the LSS forward and
    backward kernels' launches on the card."""
    from omnihd_scenes_tpu_torch.config import MTLConfig
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-3
    runs = {}
    for device in ('cpu', dev):
        model = (BEVFusionMTL(cfg) if isinstance(cfg, MTLConfig)
                 else BEVFusion(cfg))
        model.load_state_dict(sd)
        model.to(device)
        state = create_train_state(model, lambda p: make_optimizer(
            p, make_lr_schedule(lr, 10, warmup_iters=0)))
        loss_fn = make_loss_fn_generic(model, mtype,
                                       cfg.pillars.anchors(),
                                       camera_depth_range=(1.0, 9.0, 1.0))
        grads = {}
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g))
                 for k, p in model.named_parameters()]
        launches = (lss_sample_bev.launches,
                    lss_sample_bev_backward.launches)
        _, loss, _ = make_train_step(loss_fn)(state, batch)
        for h in hooks:
            h.remove()
        runs[str(device)] = dict(
            loss=float(loss), launches=(
                lss_sample_bev.launches - launches[0],
                lss_sample_bev_backward.launches - launches[1]),
            grads={k: v.cpu() for k, v in grads.items()},
            state={k: v.cpu() for k, v in model.state_dict().items()})
    cpu, gpu = runs['cpu'], runs[str(dev)]
    assert cpu['launches'] == (0, 0) and gpu['launches'] == expect
    assert abs(gpu['loss'] - cpu['loss']) <= 1e-5 * abs(cpu['loss'])
    diff = sum(float((gpu['grads'][k] - g).square().sum())
               for k, g in cpu['grads'].items())
    norm = sum(float(g.square().sum()) for g in cpu['grads'].values())
    assert diff ** 0.5 <= 1e-4 * norm ** 0.5
    for k, v in cpu['state'].items():
        if not v.is_floating_point():
            continue
        err = float((gpu['state'][k] - v).abs().max())
        if 'running' in k:
            assert err <= 1e-4 * float(v.abs().max()), k
        else:
            assert err <= 2.5 * lr, k


CL = torch.channels_last


def _qconv_case(dev, n, h, w, c, co, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x8 = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=dev,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    w8 = torch.randint(-127, 128, (co, 3, 3, c), generator=gen, device=dev,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    scale = torch.rand(co, generator=gen, device=dev) * 9e-4 + 1e-4
    shift = torch.randn(co, generator=gen, device=dev)
    return x8, w8, scale, shift


def bf16_ulps(got, want):
    """Distance in bf16 units in the last place, entry by entry."""
    g = got.float().to(torch.bfloat16).view(torch.int16).int()
    w = want.float().to(torch.bfloat16).view(torch.int16).int()
    return (g - w).abs()


@pytest.mark.parametrize('n,h,w,c,co,relu,out_dtype', [
    (1, 7, 9, 128, 128, True, torch.float32),
    (2, 13, 17, 256, 384, False, torch.bfloat16),
    (3, 5, 33, 384, 256, True, torch.bfloat16),
    (1, 9, 11, 768, 128, False, torch.float32),
    (2, 6, 131, 128, 768, True, torch.bfloat16),
    (4, 1, 1, 256, 256, False, torch.float32),
    # Edge shapes of the block tiling: an image smaller than a tile,
    # widths that split tiles (ResNet layer4's 17x30), the fuse.conv
    # channels (C=640 -> Co=384), Co not a multiple of the channel tile.
    (2, 7, 9, 128, 256, True, torch.float32),
    (2, 17, 30, 512, 512, False, torch.bfloat16),
    (1, 16, 24, 640, 384, True, torch.float32),
    (2, 9, 13, 128, 136, False, torch.float32),
    (1, 3, 200, 256, 8, True, torch.bfloat16)])
def test_qconv_matches_plain(dev, n, h, w, c, co, relu, out_dtype):
    x8, w8, scale, shift = _qconv_case(dev, n, h, w, c, co)
    before = qconv3x3.launches
    got = qconv3x3(x8, w8, scale, shift, relu=relu, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qconv3x3.launches == before + 1
    assert got.shape == (n, co, h, w) and got.dtype == out_dtype
    assert got.is_contiguous(memory_format=CL)
    want = qconv3x3_reference(x8, w8, scale, shift, relu=relu,
                              out_dtype=torch.float32)
    if out_dtype == torch.float32:
        assert bool(((got - want).abs()
                     <= 2.0 ** -22 * want.abs() + 1e-30).all())
    else:
        ulp = bf16_ulps(got, want)
        assert int(ulp.max()) <= 1
        assert float((ulp > 0).float().mean()) < 1e-3


def test_qconv_sums_do_not_overflow(dev):
    """All codes at +-127 with matching weights: the largest sums a
    layer can produce (127^2 * 9 * C) come out exact."""
    c = 1024
    x8 = torch.full((1, c, 4, 5), 127, dtype=torch.int8, device=dev)
    x8 = x8.contiguous(memory_format=CL)
    w8 = torch.full((128, c, 3, 3), -127, dtype=torch.int8, device=dev)
    w8 = w8.contiguous(memory_format=CL)
    one = torch.ones(128, device=dev)
    got = qconv3x3(x8, w8, one, torch.zeros_like(one), relu=False,
                   out_dtype=torch.float32)
    want = qconv3x3_reference(x8, w8, one, torch.zeros_like(one),
                              relu=False, out_dtype=torch.float32)
    assert float(want.min()) == -127.0 ** 2 * 9 * c
    assert torch.equal(got, want)


def _bconv_reference_f32(x, w, scale, shift, relu, d):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float(), w.float(), padding=d, dilation=d)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    y = y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    return y.clamp_min(0.0) if relu else y


@pytest.mark.parametrize('n,h,w,c,co,d,relu', [
    (2, 16, 24, 128, 128, 1, True),
    (1, 8, 40, 256, 128, 2, False),
    (3, 17, 23, 384, 256, 6, True),
    (1, 19, 21, 256, 768, 12, False),
    (2, 9, 13, 768, 128, 18, True),
    # Edge shapes of the block tiling (as for qconv), and d = 18 on an
    # image smaller than the dilation.
    (4, 1, 1, 128, 128, 1, True),
    (1, 7, 9, 256, 256, 6, False),
    (2, 17, 30, 256, 256, 12, True),
    (1, 6, 131, 128, 128, 6, False),
    (2, 9, 13, 128, 256, 18, True),
    (1, 16, 24, 640, 384, 1, True),
    (2, 9, 13, 128, 136, 2, False)])
def test_bconv_matches_plain(dev, n, h, w, c, co, d, relu):
    gen = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    wt = (torch.randn((co, 3, 3, c), generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    scale = torch.rand(co, generator=gen, device=dev) + 0.5
    shift = torch.randn(co, generator=gen, device=dev) * 0.1
    before = bconv3x3.launches
    got = bconv3x3(x, wt, scale, shift, relu=relu, dilation=d)
    torch.cuda.synchronize()
    assert bconv3x3.launches == before + 1
    assert got.shape == (n, co, h, w) and got.dtype == torch.bfloat16
    want = _bconv_reference_f32(x, wt, scale, shift, relu, d)
    rounded = want.to(torch.bfloat16).float()
    _, exp = torch.frexp(rounded)
    ulp = torch.ldexp(torch.ones_like(rounded), exp - 8)
    slack = (got.float() - rounded).abs() - ulp
    assert float(slack.max()) <= 1e-5 * float(want.abs().max())


def test_bconv_defaults_are_identity_affine(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, 128, 8, 16), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=CL)
    wt = (torch.randn((128, 128, 3, 3), generator=gen, device=dev)
          * 0.05).to(torch.bfloat16).contiguous(memory_format=CL)
    got = bconv3x3(x, wt, relu=False)
    ones = torch.ones(128, device=dev)
    assert torch.equal(got, bconv3x3(x, wt, ones, ones * 0, relu=False))
    assert bool((got < 0).any())


def test_conv_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x8, w8, scale, shift = _qconv_case(dev, 1, 5, 6, 128, 128)
    with pytest.raises(ValueError, match='device'):
        qconv3x3(x8, w8.cpu(), scale, shift)
    with pytest.raises(TypeError):
        qconv3x3(x8.float(), w8, scale, shift)
    with pytest.raises(TypeError):
        qconv3x3(x8, w8, scale, shift, out_dtype=torch.float16)
    with pytest.raises(ValueError, match='channels_last'):
        qconv3x3(x8.contiguous(), w8, scale, shift)
    with pytest.raises(ValueError, match='channels_last'):
        qconv3x3(x8, w8.contiguous(), scale, shift)
    with pytest.raises(ValueError, match='C \\* itemsize'):
        qconv3x3(*_qconv_case(dev, 1, 5, 6, 96, 128))
    with pytest.raises(ValueError, match='Co % 8'):
        qconv3x3(*_qconv_case(dev, 1, 5, 6, 128, 12))
    with pytest.raises(ValueError, match='3, 3'):
        qconv3x3(x8, w8[:, :, :2], scale, shift)
    with pytest.raises(ValueError, match='scale'):
        qconv3x3(x8, w8, scale[:64], shift)
    xb = torch.zeros((1, 64, 5, 6), dtype=torch.bfloat16, device=dev)
    wb = torch.zeros((128, 64, 3, 3), dtype=torch.bfloat16, device=dev)
    xb, wb = xb.contiguous(memory_format=CL), wb.contiguous(memory_format=CL)
    with pytest.raises(TypeError):
        bconv3x3(xb.float(), wb)
    with pytest.raises(ValueError, match='dilation'):
        bconv3x3(xb, wb, dilation=0)
    with pytest.raises(ValueError, match='channels_last'):
        bconv3x3(xb.contiguous(), wb)
    with pytest.raises(ValueError, match='C \\* itemsize'):
        bconv3x3(xb[:, :48].contiguous(memory_format=CL),
                 wb[:, :48].contiguous(memory_format=CL))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('stride,eligible', [(1, True), (2, False)])
def test_qconv2d_int8_on_the_card_equals_the_cpu(dev, dtype, stride,
                                                 eligible):
    """A frozen int8 QConv2d on the card (the kernel when eligible, an f32
    conv of the codes otherwise) against the same layer on the CPU (the
    plain versions), on the same input: the same codes and integer sums,
    so one f32 rounding (eligible) or f32 summation order apart."""
    torch.manual_seed(0)
    conv = QConv2d(256, 128, 3, stride=stride, padding=1)
    x = torch.randn(2, 256, 9, 13)
    with torch.inference_mode():
        for mode in ('calib', 'freeze'):
            set_mode(conv, mode)
            conv(x)
    state = quant_state(conv)
    cpu = QConv2d(256, 128, 3, stride=stride, padding=1).to(dtype)
    cpu.load_state_dict(conv.state_dict())
    gpu = QConv2d(256, 128, 3, stride=stride, padding=1).to(
        device=dev, dtype=dtype, memory_format=CL)
    gpu.load_state_dict(conv.state_dict())
    for m in (cpu, gpu):
        load_quant_state(m, state)
        set_mode(m, 'int8')
    xd = x.to(dtype)
    before = qconv3x3.launches
    with torch.inference_mode():
        got = gpu(xd.to(dev).contiguous(memory_format=CL)).cpu().float()
        want = cpu(xd).float()
    assert qconv3x3.launches == before + int(eligible)
    if eligible and dtype == torch.float32:
        assert bool(((got - want).abs() <= 2.0 ** -22 * want.abs()).all())
    elif eligible:
        assert torch.equal(got, want)
    else:
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize('shape', ['tsa', 'sca', 'multi_level'])
def test_msda_on_the_card_equals_the_cpu(dev, shape):
    """Multi-scale deformable attention (plain PyTorch, ``F.grid_sample``)
    on the card against the same function on the CPU, in f32 with TF32
    off (within 1e-5 of max|ref|), chunked and whole, and in bf16 (the
    sampling positions f32 on both: within 1 bf16 ulp of the CPU's
    result); its bilinear sampler at borders and outside the map too."""
    from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
        bilinear_sample, multi_scale_deformable_attn)

    b, nq, p, shapes = {'tsa': (2, 3000, 4, ((40, 60),)),
                        'sca': (1, 3000, 8, ((17, 30),)),
                        'multi_level': (2, 500, 3, ((9, 13), (1, 5)))}[shape]
    gen = torch.Generator().manual_seed(7)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, 8, 32, generator=gen)
    loc = torch.rand(b, nq, 8, len(shapes), p, 2, generator=gen) * 1.4 - 0.2
    wgt = torch.softmax(torch.randn(b, nq, 8, len(shapes) * p,
                                    generator=gen), -1).reshape(
        b, nq, 8, len(shapes), p)
    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = multi_scale_deformable_attn(value, shapes, loc, wgt)
        for chunk in (None, 700):
            got = multi_scale_deformable_attn(
                value.to(dev), shapes, loc.to(dev), wgt.to(dev),
                query_chunk=chunk).cpu()
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
        v16, w16 = value.bfloat16(), wgt.bfloat16()
        want16 = multi_scale_deformable_attn(v16, shapes, loc, w16).float()
        got16 = multi_scale_deformable_attn(v16.to(dev), shapes, loc.to(dev),
                                            w16.to(dev)).cpu().float()
        assert float((got16 - want16).abs().max()) <= 2.0 ** -7 * float(
            want16.abs().max())
        h, w = shapes[0]
        grid = value[:, :h * w, 0].reshape(b, h, w, 32)
        pix = torch.rand(b, 500, 2, generator=gen) * torch.tensor(
            [w + 2.0, h + 2.0]) - 1.5
        torch.testing.assert_close(
            bilinear_sample(grid.to(dev), pix.to(dev)).cpu(),
            bilinear_sample(grid, pix), rtol=0, atol=1e-5)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow


# ---- camera decode on the card: the IDCT and rectify kernels ------------

JPEG_FIXTURES_ROOT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), 'torch_port_fixtures')
JPEG_FIXTURES = os.path.join(JPEG_FIXTURES_ROOT, 'jpeg')
sys.path.insert(0, JPEG_FIXTURES_ROOT)      # idct_cases
FIXTURE_NAMES = ('camera_1080p_420', 'noise_64x96_420', 'noise_64x96_444')


def _planes_case(gen, hw, mode, dist, dev):
    """Seeded random planes of an (h, w) image sampled ``mode`` (the Y
    plane a view with a wider pitch, as the decode's planes are), and the
    undistortion map of a camera with ``dist`` (None without)."""
    from omnihd_scenes_tpu_torch.data.undistort import rectify_map
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    h, w = hw
    shape = R.chroma_shape(hw, mode)
    y = torch.randint(0, 256, (h, w + 8), dtype=torch.uint8,
                      generator=gen).to(dev)[:, :w]
    cb, cr = (torch.randint(0, 256, shape, dtype=torch.uint8,
                            generator=gen).to(dev) for _ in range(2))
    k = [[w * 0.8, 0.0, w / 2.0], [0.0, w * 0.8, h / 2.0], [0.0, 0.0, 1.0]]
    fixed = rectify_map(k, dist, hw)
    return (R.Planes(y, cb, cr, mode),
            None if fixed is None else torch.from_numpy(fixed).to(dev))


DIST = (-0.05, 0.01, 1e-3, -1e-3, 0.0)
R_MEAN, R_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


@pytest.mark.parametrize('hw', [(72, 128), (65, 97), (1080, 1920)])
def test_rectify_passes_match_plain(dev, hw):
    """The fused rectify kernel, one launch per call, bit-equal to its
    plain version on the card with each step of the chain alone and
    together: YCbCr -> BGR of 4:4:4 / 4:2:2 / 4:2:0 planes, the remap,
    the u8 resizes (the exact 2x and 0.7), the f32 resize (0.5, 0.8, the
    same size), padded and cropped."""
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    gen = torch.Generator().manual_seed(0)
    h, w = hw
    launches = R.rectify.launches
    calls = 0
    for mode in (R.CHROMA_444, R.CHROMA_422, R.CHROMA_420):
        planes, m = _planes_case(gen, hw, mode, DIST, dev)
        for use_map in (False, True):
            for u8 in ((h, w), (h // 2, w // 2), (int(h * 0.7), int(w * 0.7))):
                outs = [u8, (u8[0] // 2, u8[1] // 2),
                        (int(u8[0] * 0.8), int(u8[1] * 0.8))]
                target = (u8[0] + 8, u8[1] + 32) if use_map else \
                    (u8[0] // 2, u8[1] // 3)
                args = ([planes] * 3, [m if use_map else None] * 3,
                        [u8] * 3, outs, target, R_MEAN, R_STD)
                got = R.rectify(*args)
                calls += 1
                assert torch.equal(got, R.rectify_plain(*args)), \
                    (mode, use_map, u8)
    assert R.rectify.launches == launches + calls


def test_rectify_chain_matches_plain(dev):
    """The whole chain of a six-camera batch of two samples (4:2:0 1080p
    planes, undistorted or not, front and back halved, 0.5 resize, padded
    to 544x960) in one launch, bit-equal to ``rectify_plain``."""
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    gen = torch.Generator().manual_seed(1)
    planes, maps, u8_hws, out_hws = [], [], [], []
    for k in range(12):
        p, m = _planes_case(gen, (1080, 1920), R.CHROMA_420,
                            DIST if k % 3 else (0.0,) * 5, dev)
        planes.append(p)
        maps.append(m)
        fb = k % 6 in (0, 3)
        u8_hws.append((540, 960) if fb else (1080, 1920))
        out_hws.append((270, 480) if fb else (540, 960))
    before = R.rectify.launches
    got = R.rectify(planes, maps, u8_hws, out_hws, (544, 960), R_MEAN, R_STD)
    assert R.rectify.launches == before + 1
    want = R.rectify_plain(planes, maps, u8_hws, out_hws, (544, 960),
                           R_MEAN, R_STD)
    assert torch.equal(got, want)


def test_rectify_per_camera_maps_match_plain(dev):
    """Two samples of six cameras, each camera with its own calibration
    (focal length and centre moved) kept as a ``DeviceMap``: the launch,
    with the images of one map interleaved tile by tile and laid out image
    by image, bit-equal to ``rectify_plain``; each camera's tables are
    made once."""
    from omnihd_scenes_tpu_torch.data.undistort import rectify_map
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    gen = torch.Generator().manual_seed(2)
    hw = (1080, 1920)
    own = []
    for cam in range(6):
        k = np.array([[1536.0 * (1 + 0.01 * cam), 0.0, 960.0 + 2 * cam],
                      [0.0, 1536.0 * (1 + 0.01 * cam), 540.0],
                      [0.0, 0.0, 1.0]])
        own.append(R.DeviceMap(torch.from_numpy(
            rectify_map(k, DIST, hw)).to(dev)))
    planes = [_planes_case(gen, hw, R.CHROMA_420, (0.0,) * 5, dev)[0]
              for _ in range(12)]
    maps = [own[j % 6] for j in range(12)]
    fb = [j % 6 in (0, 3) for j in range(12)]
    args = ([(540, 960) if f else hw for f in fb],
            [(270, 480) if f else (540, 960) for f in fb], (544, 960),
            R_MEAN, R_STD)
    want = R.rectify_plain(planes, maps, *args)
    tables = R.geometry_tables.launches
    assert torch.equal(R.rectify(planes, maps, *args), want)
    assert R.geometry_tables.launches == tables + 6
    assert torch.equal(R._launch(planes, maps, *args, interleave=False),
                       want)
    assert R.geometry_tables.launches == tables + 6


@pytest.mark.parametrize('hw', [(65, 97), (1080, 1920)])
def test_rectify_setup_kernels_match_plain(dev, hw):
    """rectify's setup kernels bit-equal to their plain versions on the
    card: the packed map (one launch), and each image geometry's tile
    footprints (with and without a map) and resize taps, at the u8 sizes
    and f32 resizes of the chain, all three tables from one launch a
    (map, geometry)."""
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    gen = torch.Generator().manual_seed(4)
    h, w = hw
    _, fixed = _planes_case(gen, hw, R.CHROMA_420, DIST, dev)
    counts = (R.pack_map.launches, R.geometry_tables.launches)
    assert torch.equal(R.pack_map(fixed), R.pack_map_plain(fixed))
    calls = 0
    for u8 in ((h, w), (h // 2, w // 2), (int(h * 0.7), int(w * 0.7))):
        for out in (u8, (u8[0] // 2, u8[1] // 2),
                    (int(u8[0] * 0.8), int(u8[1] * 0.8))):
            target = (out[0] + 8, out[1] - 3)
            geo = R._geometry(h, w, R.CHROMA_420, u8, out, target)
            for m in (fixed, None):
                before = R.geometry_tables.launches
                got = R.geometry_tables(m, geo, target, dev)
                assert R.geometry_tables.launches == before + 1
                want = (R.footprint_table_plain(m, geo, target, dev),
                        *R.resize_taps_plain(geo, dev))
                assert len(got) == len(want) == 3
                for a, b, what in zip(got, want,
                                      ('footprint', 'row taps', 'col taps')):
                    assert torch.equal(a, b), (u8, out, m is None, what)
                calls += 1
    assert (R.pack_map.launches, R.geometry_tables.launches) == (
        counts[0] + 1, counts[1] + calls)


def test_rectify_refuses_what_the_kernel_does_not_take(dev):
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    y = torch.zeros((8, 8), dtype=torch.uint8, device=dev)
    c = torch.zeros((4, 4), dtype=torch.uint8, device=dev)
    good = R.Planes(y, c, c, R.CHROMA_420)
    args = ([(8, 8)], [(8, 8)], (8, 8), R_MEAN, R_STD)
    with pytest.raises(ValueError):
        R.rectify([good._replace(y=y.float())], [None], *args)
    with pytest.raises(ValueError):
        R.rectify([good._replace(y=y.t())], [None], *args)
    with pytest.raises(ValueError):
        R.rectify([good._replace(mode=R.CHROMA_444)], [None], *args)
    with pytest.raises(ValueError):
        R.rectify([good], [torch.zeros((8, 8, 2), dtype=torch.int64,
                                       device=dev)], *args)


def _fixture(name):
    with open(os.path.join(JPEG_FIXTURES, f'{name}.jpg'), 'rb') as f:
        data = np.frombuffer(f.read(), np.uint8)
    return data, np.load(os.path.join(JPEG_FIXTURES, f'{name}.npz'))['bgr']


def test_card_decode_matches_the_fixtures(dev):
    """The card's decode (host entropy decode, the IDCT kernel, the
    rectify kernel's colour step) of the committed JPEGs equals their
    ``cv2.imdecode`` result exactly (max |d| 0); one batched decode, one
    IDCT launch, no nvJPEG decode."""
    from omnihd_scenes_tpu_torch.data import jpeg as J
    from omnihd_scenes_tpu_torch.kernels.jpeg_idct import jpeg_idct

    blobs, refs = zip(*[_fixture(n) for n in FIXTURE_NAMES])
    calls, idct, nv = (J.decode_jpeg_planes.calls, jpeg_idct.launches,
                       J.nvjpeg_decode_planes.calls)
    got = J.decode_jpegs(list(blobs), dev)
    assert J.decode_jpeg_planes.calls == calls + 1
    assert jpeg_idct.launches == idct + 1
    assert J.nvjpeg_decode_planes.calls == nv
    for name, g, want in zip(FIXTURE_NAMES, got, refs):
        d = np.abs(g.cpu().numpy().astype(int) - want.astype(int))
        assert d.max() == 0, (name, d.max(), (d > 0).sum())


def test_jpeg_idct_matches_plain(dev):
    """The IDCT kernel bit-equal to ``jpeg_idct_plain`` on the card: on
    the fixtures' own coefficients and on seeded random int16 blocks with
    8- and 16-bit tables, extreme values included (every word wraps alike
    in both), over a layout of odd block grids, at the edges of the
    kernel's chunks (block rows of K, K + 1 and 2K - 1 blocks, K =
    ``CHUNK_BLOCKS``; a 1x1-block image) and at the b4 camera batch's
    layout (24 images, 1080p 4:2:0); one launch a call."""
    from omnihd_scenes_tpu_torch.data import jpeg as J
    from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI

    c = J.entropy_decode([_fixture(n)[0] for n in FIXTURE_NAMES])
    coefs, quant = c.coefs.to(dev), c.quant.to(dev)
    launches = JI.jpeg_idct.launches
    assert torch.equal(JI.jpeg_idct(coefs, quant, c.comps),
                       JI.jpeg_idct_plain(coefs, quant, c.comps))
    from idct_cases import LAYOUTS, idct_case

    rng = np.random.RandomState(0)
    coefs, quant, layout = idct_case(rng, LAYOUTS['odd'])
    got = JI.jpeg_idct(coefs.to(dev), quant.to(dev), layout)
    assert torch.equal(got, JI.jpeg_idct_plain(coefs.to(dev), quant.to(dev),
                                               layout))
    assert torch.equal(got.cpu(), JI.jpeg_idct_plain(coefs, quant, layout))
    for grids in (LAYOUTS['chunk_edges'], LAYOUTS['b4_1080p_420']):
        coefs, quant, layout = idct_case(rng, grids)
        coefs, quant = coefs.to(dev), quant.to(dev)
        got = JI.jpeg_idct(coefs, quant, layout)
        torch.cuda.synchronize()
        assert torch.equal(got, JI.jpeg_idct_plain(coefs, quant, layout)), \
            grids[:3]
    assert JI.jpeg_idct.launches == launches + 4


def test_jpeg_idct_launch_refuses_another_chunk_length(dev):
    """The chunk length is fixed in ``csrc/jpeg_idct.cu`` (``kChunk``): a
    launch given another one than ``CHUNK_BLOCKS`` returns
    cudaErrorInvalidValue (1) and writes nothing."""
    from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI

    coefs = torch.zeros(40 * 64, dtype=torch.int16, device=dev)
    quant = torch.ones(1, 64, dtype=torch.int32, device=dev)
    desc, chunks_at, n_chunks = JI.idct_descriptor(np.array([[0, 1, 40]]))
    desc = desc.to(dev)
    out = torch.zeros(coefs.shape, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k in (JI.CHUNK_BLOCKS // 2, JI.CHUNK_BLOCKS * 2):
        assert JI._kernel()(coefs.data_ptr(), quant.data_ptr(),
                            desc.data_ptr(), desc.data_ptr() + chunks_at,
                            n_chunks, k, 40, out.data_ptr(), stream) == 1
    torch.cuda.synchronize()
    assert out.max() == 0


@pytest.mark.parametrize('hw', [(65, 97), (1080, 1920)])
def test_ycbcr_pass_matches_plain(dev, hw):
    """The rectify kernel's colour step alone (``planes_to_bgr``: libjpeg's
    fancy chroma upsampling and colour tables, one launch) bit-equal to
    ``ycbcr_to_bgr_plain`` on the card, for 4:4:4, 4:2:2 and 4:2:0 planes
    of odd and even sizes."""
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    gen = torch.Generator().manual_seed(3)
    planes = [_planes_case(gen, hw, mode, (0.0,) * 5, dev)[0]
              for mode in (R.CHROMA_444, R.CHROMA_422, R.CHROMA_420)]
    launches = R.rectify.launches
    got = R.planes_to_bgr(planes)
    assert R.rectify.launches == launches + 1
    for g, p in zip(got, planes):
        assert torch.equal(g, R.ycbcr_to_bgr_plain(*p))


def test_nvjpeg_encode_round_trip(dev):
    """nvJPEG's encoder writes a baseline 4:2:0 JPEG (``cv2.imwrite``'s
    defaults), which decodes back to the image within a few levels on
    average."""
    from omnihd_scenes_tpu_torch.data.jpeg import (decode_jpegs,
                                                   encode_jpeg, jpeg_header)
    from omnihd_scenes_tpu_torch.kernels.rectify import CHROMA_420

    _, img = _fixture('camera_1080p_420')
    data = encode_jpeg(img, dev)
    header = jpeg_header(data)
    assert header.baseline and header.chroma == CHROMA_420
    assert (header.height, header.width) == img.shape[:2]
    (back,) = decode_jpegs([np.frombuffer(data, np.uint8)], dev)
    d = np.abs(back.cpu().numpy().astype(int) - img.astype(int))
    assert d.mean() <= 1.5, d.mean()


def test_card_decode_refuses_progressive(dev):
    """A progressive frame header is refused before any decode."""
    from omnihd_scenes_tpu_torch.data.jpeg import decode_jpegs, jpeg_header

    data, _ = _fixture('noise_64x96_444')
    data = data.copy()
    sof = bytes(data).index(b'\xff\xc0')
    data[sof + 1] = 0xC2
    assert not jpeg_header(data).baseline
    with pytest.raises(ValueError, match='progressive'):
        decode_jpegs([data], dev)


# -- the image augmentation kernels and the decode on the prefetch stream --

def _photometric_rows(n, seed):
    """Rows covering each step on and off, both contrast modes, a channel
    swap and an identity row."""
    from omnihd_scenes_tpu_torch.data.augmentation import draw_photometric

    rows = draw_photometric(np.random.RandomState(seed), n, per_view=True)
    rows[0] = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2)
    rows[1] = (1, -31.5, 1, 1, 1.4, 1, 0.6, 1, 17.0, 1, 2, 0, 1)
    rows[2] = (1, 20.0, 0, 1, 0.55, 1, 1.45, 1, -17.9, 1, 1, 2, 0)
    return rows


@pytest.mark.parametrize('shape', [(6, 65, 97), (24, 544, 960)])
def test_photometric_matches_plain(dev, shape):
    """Bit-equal to the plain version on the card and on the CPU, pad
    band, channel ties and all."""
    from omnihd_scenes_tpu_torch.kernels.photometric import (
        photometric, photometric_plain)

    gen = torch.Generator().manual_seed(shape[0])
    imgs = torch.randn(shape + (3,), generator=gen) * 1.7
    imgs[:, -8:] = 0.0
    imgs[:, :4, :, 1] = imgs[:, :4, :, 0]
    imgs[:, 4:8, :, 2] = imgs[:, 4:8, :, 1]
    rows = _photometric_rows(shape[0], 5)
    before = photometric.launches
    got = photometric(imgs.to(dev), rows)
    torch.cuda.synchronize()
    assert photometric.launches == before + 1
    assert torch.equal(got, photometric_plain(imgs.to(dev), rows))
    if shape[0] <= 6:
        assert torch.equal(got.cpu(), photometric_plain(imgs, rows))


@pytest.mark.parametrize('crop,out_hw', [
    ((120, 68, 840, 476), (544, 960)), ((0, 0, 960, 544), (544, 960)),
    ((-40, 10, 2000, 300), (200, 333)), ((5, 7, 61, 39), (17, 29))])
def test_crop_resize_flip_matches_plain(dev, crop, out_hw):
    """Bit-equal to the plain version on the card, flips mixed in one
    launch; a same-size crop is a copy."""
    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip, crop_resize_flip_plain)

    imgs = torch.randn((4, 544, 960, 3),
                       generator=torch.Generator().manual_seed(1)).to(dev)
    rec = np.array([[out_hw[1], out_hw[0], *crop, f] for f in (0, 1, 1, 0)],
                   np.int64)
    before = crop_resize_flip.launches
    got = crop_resize_flip(imgs, rec)
    torch.cuda.synchronize()
    assert crop_resize_flip.launches == before + 1
    assert tuple(got.shape) == (4, *out_hw, 3)
    assert torch.equal(got, crop_resize_flip_plain(imgs, rec))
    unflipped = crop_resize_flip(imgs, rec * [1, 1, 1, 1, 1, 1, 0])
    assert torch.equal(got[1], unflipped[1].flip(1))
    assert torch.equal(got[0], unflipped[0])


def test_augmentation_kernels_refuse_what_they_do_not_take(dev):
    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip)
    from omnihd_scenes_tpu_torch.kernels.photometric import photometric

    imgs = torch.zeros((3, 8, 8, 3), device=dev)
    with pytest.raises(ValueError, match='params'):
        photometric(imgs, np.zeros((2, 13), np.float32))
    bad = _photometric_rows(3, 0)
    bad[0, 10:13] = (0, 0, 1)
    with pytest.raises(ValueError, match='permutation'):
        photometric(imgs, bad)
    with pytest.raises(ValueError, match='records'):
        crop_resize_flip(imgs, np.array([[4, 4, 0, 0, 8, 8, 0]] * 2))
    with pytest.raises(ValueError, match='one output size'):
        crop_resize_flip(imgs, np.array([[4, 4, 0, 0, 8, 8, 0],
                                         [4, 4, 0, 0, 8, 8, 1],
                                         [5, 4, 0, 0, 8, 8, 0]]))
    with pytest.raises(ValueError, match='leaves nothing'):
        crop_resize_flip(imgs, np.array([[4, 4, 9, 0, 12, 8, 0]] * 3))


def test_prefetch_decodes_on_its_stream_as_on_the_current(dev, tmp_path):
    """Device-decode training batches (photometric and crop-resize-flip
    records) decoded by the prefetch thread on its side stream equal the
    same batches decoded on the current stream; one IDCT, rectify,
    photometric and crop_resize_flip launch a batch."""
    from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
    from omnihd_scenes_tpu_torch.data.image_loading import (
        HOST_KEYS, decode_camera_batch)
    from omnihd_scenes_tpu_torch.data.loader import TrainLoader
    from omnihd_scenes_tpu_torch.data.prefetch import prefetch
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)
    from omnihd_scenes_tpu_torch.kernels import launch_counts
    from omnihd_scenes_tpu_torch.train.loop import batch_to

    root = str(tmp_path / 'synth')
    generate(root, 'v1.0-mini', SyntheticConfig(
        n_scenes=2, samples_per_scene=4, image_hw=(216, 384),
        cam_distortion=(-0.05, 0.01, 1e-3, -1e-3, 0.0)),
        image_device='cuda')
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)

    def loader():
        ds = NewScenesDetDataset(
            f'{root}/synth_infos_temporal_train.pkl', modality='camera',
            use_camera=True, image_decode='device', seed=4, aug={
                'photometric': 'per_view', 'rot_scale_flip_image': {},
                'crop_resize_flip': {'resize': [96], 'crop': (16, 8, 176,
                                                              104),
                                     'rand_flip': True}})
        return TrainLoader(ds, 2, seed=1)

    want = [decode_camera_batch({
        **batch_to({k: v for k, v in b.items() if k not in HOST_KEYS}, dev),
        **{k: b[k] for k in HOST_KEYS}}, dev) for b in loader()]
    before = launch_counts()
    got = list(prefetch(iter(loader()), device=dev))
    after = launch_counts()
    torch.cuda.synchronize()
    assert len(got) == len(want) == 2
    for name in ('jpeg_idct', 'rectify', 'photometric', 'crop_resize_flip'):
        assert after[name] - before[name] == 2, name
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert tuple(g['imgs'].shape) == (2, 6, 96, 160, 3)
        for k in w:
            assert torch.equal(g[k].cpu(), w[k].cpu()), k


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_registered_op_matches_plain(dev, dtype):
    """``torch.ops.omnihd.lss_sample_bev`` (what the model and an exported
    program call) on card tensors: one launch of the fused kernel, within
    the wrapper's bound of the plain version; its backward op one launch
    of the backward kernel, within its bound of the plain scatter."""
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        _mask, geom_values, lss_sample_bev_backward_op, lss_sample_bev_op)

    grad, feat, depth, minv, mt, g = _grad_case(dev, 2, dtype, seed=12)
    args = (geom_values(g), _mask(SOLVE_X))
    before = (lss_sample_bev.launches, lss_sample_bev_backward.launches)
    got = torch.ops.omnihd.lss_sample_bev(feat, depth, minv, mt, *args)
    back = lss_sample_bev_backward_op(grad, feat, depth, minv, mt, *args)
    torch.cuda.synchronize()
    assert (lss_sample_bev.launches, lss_sample_bev_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    want = lss_sample_bev_reference(feat, depth, minv, mt, g, SOLVE_X,
                                    torch.float32)
    if dtype == torch.bfloat16:
        want = want.to(torch.bfloat16).float()
    _check(got, want)
    _check_backward(back, lss_sample_bev_backward_reference(
        grad, feat, depth, minv, mt, g, SOLVE_X))
    assert torch.equal(got, lss_sample_bev_op(feat, depth, minv, mt, *args))


def _fused_case(seed=9):
    """The small config's weights with BN statistics away from (0, 1), and
    their fused state dict (``serve/fuse.py``, traced on the CPU)."""
    import numpy as np

    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.fuse import fuse_model
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from omnihd_scenes_tpu_torch.weights import load_state_dict

    cfg, sd, _ = _small_train_case(seed=seed)
    rng = np.random.RandomState(seed)
    for k in [k for k in sd if k.endswith('.running_var')]:
        sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, sd[k].shape)
                                 .astype(np.float32))
    request = random_request(np.random.RandomState(seed), cfg, 2, 600)
    model = BEVFusion(cfg)
    load_state_dict(model, sd)
    inputs = [torch.from_numpy(x) for x in request]
    fused, report = fuse_model(model, lambda: model(*inputs))
    assert report['fused'] and not report['skipped']
    return cfg, sd, fused, request


def test_fused_serving_on_the_card_equals_unfused(dev):
    """f32 ``Predictor`` on the card (TF32 off): the fused checkpoint's
    network (passthroughs folded) within 1e-4 of max|ref| of the unfused
    one's, the same kept rows."""
    from chip_smoke import kept_row_distance
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sd, fused, request = _fused_case()
    preds = [Predictor(cfg, s, device=dev, dtype=torch.float32)
             for s in (sd, fused)]
    want, got = (p.forward(*request) for p in preds)
    for key in ('bev', 'cls_score', 'bbox_pred', 'dir_pred'):
        assert float((got[key] - want[key]).abs().max()) <= 1e-4 * float(
            want[key].abs().max()), key
    dets = [[t.cpu() for t in p(*request)] for p in preds]
    for s in range(2):
        assert int(dets[0][3][s].sum()) == int(dets[1][3][s].sum())
        assert kept_row_distance(dets[1], dets[0], s) < 1e-3


def test_bundle_exported_on_the_card(dev, tmp_path):
    """A bf16 bundle of the small fused model exported on the card: loaded
    back it launches the LSS kernel once a request inside the program and
    equals the live bf16 ``Predictor``'s kept rows."""
    from chip_smoke import kept_row_distance
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.export import (export_model,
                                                      load_exported)
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor

    cfg, _, fused, request = _fused_case(seed=10)
    out = export_model(BEVFusion(cfg), 'bevfusion', fused, request,
                       str(tmp_path / 'bundle'),
                       anchors=cfg.pillars.anchors(), device=dev)
    loaded = load_exported(out, dev)
    before = lss_sample_bev.launches
    got = [t.cpu() for t in loaded(*request)]
    torch.cuda.synchronize()
    assert lss_sample_bev.launches == before + 1
    want = [t.cpu() for t in Predictor(cfg, fused, device=dev)(*request)]
    for s in range(2):
        assert int(got[3][s].sum()) == int(want[3][s].sum())
        assert kept_row_distance(got, want, s) < 1e-3


@pytest.fixture
def no_tf32(dev):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield dev
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_center_head_on_the_card_equals_cpu(no_tf32):
    """CenterPoint on the card (TF32 off) against the CPU: the f32
    forward within 1e-4 of max|ref| per map, the targets' grid indices
    equal (centres on cell boundaries included: both divide by the cell
    sizes as tensors), the loss within 1e-5 relative, the decoded boxes
    equal as multisets; no host sync in the forward, targets, loss or
    decode."""
    from chip_smoke import kept_row_distance
    from omnihd_scenes_tpu_torch.models.centerpoint_head import (
        CenterHead, CenterTargetCfg, build_center_targets,
        center_head_decode, center_head_loss)

    dev = no_tf32
    torch.manual_seed(0)
    head = CenterHead(32).eval()
    cfg = CenterTargetCfg(pc_range=(-8, -8, -3.0, 8, 8, 5.0),
                          out_hw=(16, 24))
    bev = torch.randn(2, 32, 16, 24)
    gen = np.random.RandomState(1)
    boxes = torch.from_numpy(gen.uniform(-7.5, 7.5, (2, 8, 9)).astype(
        np.float32))
    boxes[..., 3:6] = boxes[..., 3:6].abs() + 0.5
    boxes[0, 0, :2] = torch.tensor([-8 + 7 * 16 / 24, -5.0])
    labels = torch.from_numpy(gen.randint(0, 4, (2, 8)))
    mask = torch.ones(2, 8, dtype=torch.bool)
    outs = []
    for d in ('cpu', dev):
        h = copy.deepcopy(head).to(d)
        x, *args = (t.to(d) for t in (bev, boxes, labels, mask))
        with torch.no_grad():
            if d != 'cpu':
                torch.cuda.set_sync_debug_mode('error')
            try:
                preds = h(x)
                tgt = build_center_targets(*args, cfg)
                loss = center_head_loss(preds, *args, cfg)
                dec = center_head_decode(preds, cfg, max_num=100)
            finally:
                torch.cuda.set_sync_debug_mode('default')
        outs.append((preds, tgt, loss, dec))
    (p0, t0, l0, d0), (p1, t1, l1, d1) = outs
    for k in p0:
        assert float((p1[k].cpu() - p0[k]).abs().max()) <= 1e-4 * float(
            p0[k].abs().max()), k
    for k in ('gy', 'gx', 'valid'):
        assert torch.equal(t1[k].cpu(), t0[k]), k
    assert float((t1['heatmap'].cpu() - t0['heatmap']).abs().max()) < 1e-6
    for k in l0:
        assert torch.allclose(l1[k].cpu(), l0[k], rtol=1e-5, atol=0), k
    d1 = [t.cpu() for t in d1]
    assert torch.equal(d1[3].sum(-1), d0[3].sum(-1)) and d0[3].any()
    assert max(kept_row_distance(d1, d0, s) for s in range(2)) < 1e-4


def test_mm_bevformer_layer_on_the_card_equals_cpu(no_tf32):
    """The multi-modal BEVFormer layer on the card against the CPU (f32,
    TF32 off), within 1e-4 of max|ref|, and without a host sync after its
    first call."""
    from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
        MMBEVFormerLayer, get_reference_points_2d)

    dev = no_tf32
    torch.manual_seed(0)
    layer = MMBEVFormerLayer(16, embed_dims=32, num_heads=4, num_cams=2,
                             feedforward_channels=64).eval()
    with torch.no_grad():
        layer.fusion_w_cam.fill_(0.7)
        layer.fusion_w_pts.fill_(-0.4)
    nq = 48
    ref2d = torch.from_numpy(get_reference_points_2d(6, 8))
    q = torch.randn(2, nq, 32)
    args = (q, torch.randn(nq, 32), torch.stack([torch.randn(2, nq, 32), q],
                                                 1),
            torch.stack([ref2d + 0.05, ref2d])[None].expand(2, -1, -1, -1,
                                                            -1),
            torch.randn(2, 2, 24, 32), torch.rand(2, 2, nq, 4, 2) * 0.6 + 0.2,
            torch.rand(2, 2, nq, 4) < 0.7)
    lidar = torch.randn(2, nq, 16)
    with torch.no_grad():
        want = layer(*args, ((6, 8),), ((4, 6),), lidar)
        card = copy.deepcopy(layer).to(dev)
        card_args = [a.to(dev) for a in args + (lidar,)]
        # The first call makes the per-device offset normaliser.
        card(*card_args[:-1], ((6, 8),), ((4, 6),), card_args[-1])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = card(*card_args[:-1], ((6, 8),), ((4, 6),), card_args[-1])
        finally:
            torch.cuda.set_sync_debug_mode('default')
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_chamfer_on_the_card_equals_cpu(dev):
    """Chamfer on the card against the CPU on 5000 / 7000 f32 points:
    within 1e-6 relative, the same for any chunk, no host sync."""
    from omnihd_scenes_tpu_torch.ops.chamfer import chamfer_distance

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(5000, 3, generator=gen)
    b = torch.randn(7000, 3, generator=gen) * 1.5
    want = [t.item() for t in chamfer_distance(a, b)]
    a_d, b_d = a.to(dev), b.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = {c: chamfer_distance(a_d, b_d, chunk=c) for c in (512, 4096)}
    finally:
        torch.cuda.set_sync_debug_mode('default')
    for c, (ab, ba) in got.items():
        assert np.allclose([ab.item(), ba.item()], want, rtol=1e-6, atol=0)
    assert [t.item() for t in got[512]] == [t.item() for t in got[4096]]


def test_get_flops_on_the_card_equals_cpu(dev):
    """``tools/get_flops.py`` counts the same FLOPs and parameters on the
    card as on the CPU (the LSS kernel by its formula on both)."""
    from omnihd_scenes_tpu_torch.tools.get_flops import count
    from omnihd_scenes_tpu_torch.train.config import Config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(
        root, 'configs/synthetic/bevfusion_synth.py'))
    before = lss_sample_bev.launches
    assert count(cfg, dev) == count(cfg, 'cpu')
    assert lss_sample_bev.launches == before + 1
