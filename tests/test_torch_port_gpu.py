"""The LSS sampling CUDA kernel against its plain PyTorch version, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

Bound for f32 outputs: 1e-5 * max|ref| + 1e-6 (summation order over at
most 6 products; the kernel rounds products and sums separately, so it
is usually exact).
"""

import pytest
import torch

from omnihd_scenes_tpu_torch.utils.rig import ring_rig_img2lidar
from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                        lss_sample_reference)
from omnihd_scenes_tpu_torch.ops.lss_project import _Geom, sample_fields

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
