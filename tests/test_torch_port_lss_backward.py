"""The LSS view transform's backward on CPU tensors: the plain version
(``kernels/lss_sample.py:lss_sample_bev_backward_reference``, an
``index_add_`` scatter of the output gradient) against ``jax.vjp`` of the
JAX f32 einsum path ``_einsum_all`` (what the JAX ``custom_vjp`` of
``ops/pallas_splat.py`` differentiates) on the mini rig of
``tests/test_lss_project.py`` and on per-sample moved rigs, within 1e-5
of max|ref|; against torch autograd of the plain gather; and the
``LSSSampleBEV`` Function, which routes CPU tensors to the plain
versions and launches nothing.

The CUDA kernel is pixel-major: it buckets the (cell, camera) pairs by
pixel and sums each bucket in increasing cell order.  On the CPU,
``index_add_`` adds in the order of its index, which is cell order within
each pixel (a pixel belongs to one camera), so the kernel's order is the
plain version's: ``test_pixel_major_order_is_the_plain_order`` holds the
f32 d feat of that order bit-equal to the plain version, and d depth
(whose dot products the kernel reduces in another order than ``.sum(-1)``)
within 1e-5 of max|ref|, on the mini rigs and on a coarse image grid
whose longest bucket holds 64 pairs or more.  ``tests/test_torch_port_gpu.py`` and
``chip_smoke.py`` hold the kernel to this plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops import lss_project as jax_lss
from omnihd_scenes_tpu_torch.kernels import lss_sample as kern
from omnihd_scenes_tpu_torch.ops.lss_project import camera_geometry
from omnihd_scenes_tpu_torch.utils.rig import perturbed_rigs
from tests.test_lss_project import (FH, FW, NDEPTH, NX, NY, NZ, ROTS,
                                    SOLVE_X, TRANS)
from tests.test_torch_port_splat import C, GEOM_ARGS

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope='module')
def batch():
    """The mini rig and two moved copies, inputs and an output gradient."""
    rng = np.random.RandomState(12)
    logits = rng.randn(3, 6, FH, FW, NDEPTH).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feat = rng.randn(3, 6, FH, FW, C).astype(np.float32)
    grad = rng.randn(3, NY, NX, NZ, C).astype(np.float32)
    rots, trans = perturbed_rigs(ROTS, TRANS, batch=2, seed=4)
    rots = np.concatenate([ROTS[None], rots])
    trans = np.concatenate([TRANS[None], trans])
    minv, mt = camera_geometry(torch.from_numpy(rots),
                               torch.from_numpy(trans))
    return (torch.from_numpy(grad), torch.from_numpy(feat),
            torch.from_numpy(depth.astype(np.float32)), minv.contiguous(),
            mt.contiguous(), kern._Geom(*GEOM_ARGS))


@pytest.fixture(scope='module')
def plain(batch):
    return kern.lss_sample_bev_backward_reference(*batch, SOLVE_X)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize('sample', [0, 1, 2], ids=['ring', 'moved-a',
                                                     'moved-b'])
def test_plain_backward_matches_jax_vjp(batch, plain, sample):
    grad, feat, depth, minv, mt, _ = batch
    geom = jax_lss._Geom(*GEOM_ARGS)

    def fwd(d, f):
        return jax_lss._einsum_all(d, f, jnp.asarray(minv[sample].numpy()),
                                   jnp.asarray(mt[sample].numpy()), geom,
                                   SOLVE_X, None, jnp.float32)

    g = jnp.asarray(grad[sample].permute(2, 0, 1, 3).numpy())  # (nz, ny, nx, C)
    dd, df = jax.jit(lambda d, f, g: jax.vjp(fwd, d, f)[1](g))(
        depth[sample].numpy(), feat[sample].numpy(), g)
    dfeat, ddepth = plain
    assert float(np.abs(np.asarray(df)).max()) > 0
    _close(dfeat[sample].numpy(), df)
    _close(ddepth[sample].numpy(), dd)


def test_plain_backward_is_autograd_of_the_gather(batch, plain):
    grad, feat, depth, minv, mt, g = batch
    idx = kern.cell_indices(*kern.geometry_fields(minv, mt, g, SOLVE_X),
                            SOLVE_X, NY, NX, NDEPTH)
    f, d = feat.clone().requires_grad_(), depth.clone().requires_grad_()
    (kern.gather_cells(f, d, *idx, torch.float32) * grad).sum().backward()
    _close(plain[0].numpy(), f.grad.numpy())
    _close(plain[1].numpy(), d.grad.numpy())


def test_function_on_cpu(batch, plain):
    """Forward and backward of ``LSSSampleBEV`` are the plain versions on
    CPU tensors: no launch, no geometry gradient, bf16 round trip."""
    grad, feat, depth, minv, mt, g = batch
    counts = (kern.lss_sample_bev.launches,
              kern.lss_sample_bev_backward.launches)
    f, d = feat.clone().requires_grad_(), depth.clone().requires_grad_()
    mv = minv.clone().requires_grad_()
    out = kern.LSSSampleBEV.apply(f, d, mv, mt, g, SOLVE_X)
    assert torch.equal(out.detach(), kern.lss_sample_bev_reference(
        feat, depth, minv, mt, g, SOLVE_X, torch.float32))
    (out * grad).sum().backward()
    assert torch.equal(f.grad, plain[0]) and torch.equal(d.grad, plain[1])
    assert mv.grad is None
    f16 = feat.to(torch.bfloat16).requires_grad_()
    d16 = depth.to(torch.bfloat16).requires_grad_()
    out16 = kern.LSSSampleBEV.apply(f16, d16, minv, mt, g, SOLVE_X)
    assert out16.dtype == torch.bfloat16
    out16.backward(grad.to(torch.bfloat16))
    assert f16.grad.dtype == d16.grad.dtype == torch.bfloat16
    assert (kern.lss_sample_bev.launches,
            kern.lss_sample_bev_backward.launches) == counts


def test_cost_counts_the_contributing_pairs(batch):
    """4 C operations per (cell, camera) in range; bytes: the forward's
    count with the gradient in place of the output, plus d feat and d
    depth written once."""
    grad, feat, depth, minv, mt, g = batch
    j, i, kd = kern.cell_indices(*kern.geometry_fields(minv, mt, g, SOLVE_X),
                                 SOLVE_X, NY, NX, NDEPTH)
    pairs = int(((j >= 0) & (i >= 0) & (i < FW) & (kd >= 0)
                 & (kd < NDEPTH) & (j < FH)).sum())
    ops, nbytes = kern.lss_sample_bev_backward_cost(*[
        t for t in (grad, feat, depth, minv, mt)], g, SOLVE_X)
    assert ops == 4 * C * pairs > 0
    fwd = kern.lss_sample_bev_bytes(feat, depth, minv, mt, g, SOLVE_X,
                                    torch.float32)
    assert nbytes == fwd + 4 * (feat.numel() + depth.numel())


def test_backward_refuses_a_wrong_gradient(batch):
    grad, feat, depth, minv, mt, g = batch
    with pytest.raises(ValueError, match='grad must be'):
        kern.lss_sample_bev_backward(grad[:, :-1], feat, depth, minv, mt, g,
                                     SOLVE_X)
    with pytest.raises(TypeError, match="feat's dtype"):
        kern.lss_sample_bev_backward(grad.to(torch.bfloat16), feat, depth,
                                     minv, mt, g, SOLVE_X)


# Feature maps 4x7 on the mini rig: a pixel's ray meets 64 cells or more.
COARSE_HW = (4, 7)


def _coarse_case():
    rng = np.random.RandomState(13)
    shape = (1, 6) + COARSE_HW
    logits = rng.randn(*shape, NDEPTH).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    minv, mt = camera_geometry(torch.from_numpy(ROTS[None]),
                               torch.from_numpy(TRANS[None]))
    args = list(GEOM_ARGS)
    args[1] = COARSE_HW
    return (torch.from_numpy(rng.randn(1, NY, NX, NZ, C).astype(np.float32)),
            torch.from_numpy(rng.randn(*shape, C).astype(np.float32)),
            torch.from_numpy(depth), minv.contiguous(), mt.contiguous(),
            kern._Geom(*args))


def _pixel_major(grad, feat, depth, j, i, kd):
    """The kernel's order in plain PyTorch: the in-range (cell, camera)
    pairs bucketed by pixel, each bucket summed in increasing cell order
    (all buckets' r-th pairs at once: they hit distinct pixels).  Returns
    d feat and d depth in f32 and the bucket lengths."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    ny, nx, nz = j.shape[1:4]
    cells = ny * nx * nz
    ok = ((j >= 0) & (j < f_h) & (i >= 0) & (i < f_w) & (kd >= 0)
          & (kd < d_bins))
    bb, y, x, z, n = torch.nonzero(ok, as_tuple=True)
    cell = (y * nx + x) * nz + z
    pix = ((bb * n_cams + n) * f_h + j[ok]) * f_w + i[ok]
    order = torch.argsort(pix * cells + cell)
    pix, cell, bb, kd = pix[order], cell[order], bb[order], kd[ok][order]
    counts = torch.bincount(pix, minlength=b * n_cams * f_h * f_w)
    rank = torch.arange(len(pix)) - (torch.cumsum(counts, 0) - counts)[pix]
    g = grad.float().reshape(-1, c_ch)[bb * cells + cell]
    w = depth.float().reshape(-1, d_bins)[pix, kd]
    dot = (g * feat.float().reshape(-1, c_ch)[pix]).sum(-1)
    dfeat = torch.zeros((counts.numel(), c_ch))
    ddepth = torch.zeros((counts.numel(), d_bins))
    for r in range(int(counts.max())):
        at = rank == r
        dfeat[pix[at]] += g[at] * w[at, None]
        ddepth[pix[at], kd[at]] += dot[at]
    return dfeat.view(feat.shape), ddepth.view(depth.shape), counts


@pytest.mark.parametrize('case', ['mini', 'coarse'])
def test_pixel_major_order_is_the_plain_order(batch, plain, case):
    """Each pixel's pairs summed in increasing cell order: f32 d feat
    bit-equal to the plain ``index_add_``, d depth within 1e-5."""
    if case == 'coarse':
        args = _coarse_case()
        want = kern.lss_sample_bev_backward_reference(*args, SOLVE_X)
    else:
        args, want = batch, plain
    grad, feat, depth, minv, mt, g = args
    idx = kern.cell_indices(*kern.geometry_fields(minv, mt, g, SOLVE_X),
                            SOLVE_X, g.ny, g.nx, NDEPTH)
    dfeat, ddepth, counts = _pixel_major(grad, feat, depth, *idx)
    assert int(counts.max()) >= (64 if case == 'coarse' else 8)
    assert torch.equal(dfeat, want[0])
    _close(ddepth.numpy(), want[1].numpy())
