"""Sampling derivatives at taps that sit exactly on a texel centre
(ROADMAP queue 3 item 17), on the CPU.

Bilinear sampling is linear between texel centres and has a kink on each
of them, so its derivative with respect to the tap location is one-sided
there.  The port's two samplers -- ``ops/ms_deform_attn.py:
bilinear_sample`` (DCNv2, the BEV shift, the MTL grid crop) and
``F.grid_sample`` (deformable attention) -- both take the floor side: on
[X, X + 1) the sample is ``(1 - f) v[X] + f v[X + 1]`` with ``f = x - X``,
so d/dx at x = X is ``v[X + 1] - v[X]``, the derivative from the right.
That is also the side of the reference's mmcv DCN and MSDA CUDA kernels.

* planted taps: interior centres, the map's edges (x = 0, x = W - 1 and
  the same in y), clamped 2x2 anchors (x <= -1 or x >= W - 1), a map of
  width 1, and taps between centres;
* ``bilinear_sample`` against ``F.grid_sample`` (1e-5 of max|ref|) and
  against an f64 one-sided difference of an independent NumPy sampler
  (1e-6 of max|ref|), and, off the centres, against JAX as before;
* the JAX package's value at the centres is a recorded departure that
  the port does not mirror: its tent weights ``relu(1 - |d|)`` take +1
  for the slope of ``|d|`` at 0 and half of ``relu``'s two sides at 0,
  which the test models independently in NumPy and asserts;
* DCNv2 with zero offset convs (every tap on a centre): the offset conv's
  gradient equals that of the same layer sampled through
  ``F.grid_sample``, and JAX's stays off it;
* TSA after ``reset_offset_linears`` (its taps on centres): the MSDA
  through ``F.grid_sample`` and an MSDA composed of ``bilinear_sample``
  give the same offset gradients; JAX's gather MSDA departs.

The ROADMAP's probe (its own 5 x 6 map) read d/dx +0.0158 through JAX,
+0.3721 through the port's ``bilinear_sample`` before this change and
+0.2018 through ``F.grid_sample``.  This file's probe (a seeded 5 x 6
map, x = 2.0 and y = 1.0 on centres, ``test_roadmap_probe_values``)
reads d/dx -5.5613 through JAX, -2.0178 through the port's sampler before
this change, and -6.5702 through the port now, through ``F.grid_sample``
and by the f64 difference from the right (+3.6275 from the left).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from omnihd_scenes_tpu.models.dcn import DeformConv as JaxDeformConv
from omnihd_scenes_tpu.ops import ms_deform_attn as jax_msda
from omnihd_scenes_tpu_torch.models.bevformer import attention
from omnihd_scenes_tpu_torch.models.dcn import DeformConv
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
    bilinear_sample, multi_scale_deformable_attn)

torch.set_num_threads(1)
TOL = 1e-5          # f32 against f32: the two samplers differ in rounding
FD_TOL = 1e-6       # f32 against the f64 one-sided difference
H, W, C = 5, 6, 3


def _map(seed=0, h=H, w=W, c=C):
    return np.random.RandomState(seed).randn(1, h, w, c).astype(np.float32)


def _planted(h=H, w=W):
    """(x, y) taps: centres inside, on the edges, with clamped anchors,
    and between centres."""
    return np.array([
        [2.0, 1.0], [3.0, 2.0], [1.0, 3.0],              # interior centres
        [0.0, 2.0], [w - 1.0, 2.0], [2.0, 0.0], [2.0, h - 1.0],   # edges
        [0.0, 0.0], [w - 1.0, h - 1.0],                   # corners
        [-1.0, 2.0], [w, 1.0], [2.0, -1.0], [3.0, h],     # clamped anchors
        [-0.5, 2.0], [w - 0.5, 1.0],                      # half off the map
        [2.25, 1.0], [2.0, 1.7], [3.4, 2.6],              # off the centres
    ], np.float32)


def _cotangent(n, c, seed=1):
    return np.random.RandomState(seed).randn(1, n, c).astype(np.float32)


def port_dloc(value, loc, cot):
    """d sum(cot * bilinear_sample) / d loc, (1, n, 2)."""
    loc = torch.tensor(loc[None], requires_grad=True)
    out = bilinear_sample(torch.from_numpy(value), loc)
    (out * torch.from_numpy(cot)).sum().backward()
    return loc.grad.numpy()


def grid_sample_dloc(value, loc, cot):
    """The same through ``F.grid_sample(align_corners=False,
    padding_mode='zeros')``, the sampler of the port's MSDA."""
    _, h, w, _ = value.shape
    loc = torch.tensor(loc[None], requires_grad=True)
    size = torch.tensor([w, h], dtype=torch.float32)
    grid = ((loc + 0.5) / size * 2.0 - 1.0)[:, :, None]         # (1, n, 1, 2)
    out = F.grid_sample(torch.from_numpy(value).permute(0, 3, 1, 2), grid,
                        mode='bilinear', padding_mode='zeros',
                        align_corners=False)[..., 0]            # (1, C, n)
    (out.transpose(1, 2) * torch.from_numpy(cot)).sum().backward()
    return loc.grad.numpy()


def jax_dloc(value, loc, cot):
    def f(l):
        return jnp.sum(jax_msda.bilinear_sample(value[0], l) * cot[0])
    return np.asarray(jax.grad(f)(jnp.asarray(loc)))[None]


def _sample64(value, x, y):
    """Independent f64 bilinear sampler, zero outside the map."""
    _, h, w, c = value.shape
    x0, y0 = np.floor(x), np.floor(y)
    out = np.zeros(c)
    for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
        for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
            if 0 <= xx < w and 0 <= yy < h:
                out += wy * wx * value[0, int(yy), int(xx)].astype(np.float64)
    return out


def one_sided_dloc(value, loc, cot, step=1e-6):
    """f64 difference from the right: (f(x + h) - f(x)) / h."""
    out = np.zeros((1, len(loc), 2))
    for n, (x, y) in enumerate(loc.astype(np.float64)):
        base = _sample64(value, x, y) @ cot[0, n]
        out[0, n, 0] = (_sample64(value, x + step, y) @ cot[0, n] - base) / step
        out[0, n, 1] = (_sample64(value, x, y + step) @ cot[0, n] - base) / step
    return out


def jax_rule_dloc(value, loc, cot):
    """JAX's derivative modelled in NumPy: the clamped 2x2 patch, weights
    ``max(0, 1 - |d|)`` with d|d|/dd = 1 for d >= 0 and -1 below (JAX's
    ``abs`` takes +1 at 0) and d max(0, t)/dt = 1, 1/2, 0 for t > 0,
    t = 0, t < 0 (JAX splits a tie).  A map of height or width 1 is
    zero-padded to 2 first, as JAX does."""
    _, h, w, _ = value.shape
    value = np.pad(value, ((0, 0), (0, max(0, 2 - h)), (0, max(0, 2 - w)),
                           (0, 0)))
    h, w = max(h, 2), max(w, 2)
    out = np.zeros((1, len(loc), 2))
    for n, (x, y) in enumerate(loc.astype(np.float64)):
        xs = int(np.clip(np.floor(x), 0, w - 2))
        ys = int(np.clip(np.floor(y), 0, h - 2))

        def tent(d):
            t = 1 - abs(d)
            slope = 1.0 if t > 0 else 0.5 if t == 0 else 0.0
            return max(0.0, t), (-1.0 if d >= 0 else 1.0) * slope

        for a in range(2):
            wy, dwy = tent(y - (ys + a))
            for b in range(2):
                wx, dwx = tent(x - (xs + b))
                v = value[0, ys + a, xs + b].astype(np.float64) @ cot[0, n]
                out[0, n, 0] += v * wy * dwx
                out[0, n, 1] += v * dwy * wx
    return out


def _on_centre(loc):
    return np.any(loc == np.round(loc), -1)


def _assert_close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, f'{what}: {err} > {tol} * {scale}'


def test_roadmap_probe_values():
    """The ROADMAP's probe, recorded: x = 2.0, y = 1.0 on a 5 x 6 map."""
    value, loc = _map(), np.array([[2.0, 1.0]], np.float32)
    cot = _cotangent(1, C)
    port = port_dloc(value, loc, cot)
    grid = grid_sample_dloc(value, loc, cot)
    jax_v = jax_dloc(value, loc, cot)
    right = one_sided_dloc(value, loc, cot)
    _assert_close(port, grid, TOL, 'port vs grid_sample')
    _assert_close(port, right, FD_TOL, 'port vs the one-sided difference')
    _assert_close(jax_v, jax_rule_dloc(value, loc, cot), TOL, 'JAX rule')
    # JAX's tent derivative sits away from both one-sided derivatives.
    left = one_sided_dloc(value, loc, cot, step=-1e-6)
    assert abs(jax_v[0, 0, 0] - right[0, 0, 0]) > 0.1 * abs(right[0, 0, 0])
    assert abs(jax_v[0, 0, 0] - left[0, 0, 0]) > 0.1 * abs(left[0, 0, 0])


# Powers of two: ``F.grid_sample``'s normalisation (x + 0.5) / W * 2 - 1
# and back is exact there, so it samples at the planted centre itself.
@pytest.mark.parametrize('hw', [(4, 8), (1, 8), (4, 1), (2, 2)])
def test_bilinear_sample_takes_the_floor_side(hw):
    h, w = hw
    value = _map(sum(hw), h, w)
    loc = _planted(h, w)
    cot = _cotangent(len(loc), C, seed=h * 10 + w)
    got = port_dloc(value, loc, cot)
    _assert_close(got, grid_sample_dloc(value, loc, cot), TOL,
                  f'{hw}: bilinear_sample vs grid_sample')
    _assert_close(got, one_sided_dloc(value, loc, cot), FD_TOL,
                  f'{hw}: bilinear_sample vs the f64 one-sided difference')


@pytest.mark.parametrize('hw', [(H, W), (1, W), (2, 2)])
def test_jax_departs_at_centres_only(hw):
    """Off the centres the port holds to JAX as before; on them JAX's
    value is its tent rule's, which the port does not mirror."""
    h, w = hw
    value = _map(sum(hw) + 7, h, w)
    loc = _planted(h, w)
    cot = _cotangent(len(loc), C, seed=3)
    port, jax_v = port_dloc(value, loc, cot), jax_dloc(value, loc, cot)
    off = ~_on_centre(loc)
    _assert_close(port[:, off], jax_v[:, off], TOL, 'off the centres')
    _assert_close(jax_v, jax_rule_dloc(value, loc, cot), TOL,
                  'JAX against its modelled tent rule')
    centre = _on_centre(loc)
    assert np.abs(port[:, centre] - jax_v[:, centre]).max() > 1e-2


def _dcn_case(stride, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 16, 5).astype(np.float32)    # exact in grid_sample
    v = JaxDeformConv(6, 3, strides=stride).init(
        jax.random.PRNGKey(0), x)['params']
    kernel = np.asarray(v['kernel'])
    m = DeformConv(5, 6, stride)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        m.conv_offset.weight.zero_()
        m.conv_offset.bias.zero_()
    return x, kernel, m


def _offset_grads(m, x, cot):
    for p in m.parameters():
        p.grad = None
    out = m(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    (out * torch.from_numpy(cot)).sum().backward()
    return (m.conv_offset.weight.grad.clone(),
            m.conv_offset.bias.grad.clone())


def _grid_sample_bilinear(value, loc):
    """``bilinear_sample``'s contract through ``F.grid_sample``."""
    b, h, w, c = value.shape
    size = torch.tensor([w, h], dtype=loc.dtype)
    grid = ((loc + 0.5) / size * 2.0 - 1.0).reshape(b, -1, 1, 2)
    out = F.grid_sample(value.permute(0, 3, 1, 2), grid, mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out[..., 0].transpose(1, 2).reshape(*loc.shape[:-1], c)


@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_zero_offsets_floor_side(stride, monkeypatch):
    """Every tap of a DCN whose offset conv is zero sits on a centre; its
    offset-conv gradient equals the same layer's sampled through
    ``F.grid_sample``; JAX's sits 0.5-1.2x max|port| away."""
    from omnihd_scenes_tpu_torch.models import dcn

    x, kernel, m = _dcn_case(stride)
    out_hw = m(torch.from_numpy(x.transpose(0, 3, 1, 2))).shape[2:]
    cot = np.random.RandomState(5).randn(2, 6, *out_hw).astype(np.float32)
    got = _offset_grads(m, x, cot)
    monkeypatch.setattr(dcn, 'bilinear_sample', _grid_sample_bilinear)
    want = _offset_grads(m, x, cot)
    monkeypatch.undo()
    for g, w_, name in zip(got, want, ('kernel', 'bias')):
        _assert_close(g.numpy(), w_.numpy(), TOL, f'offset conv {name}')

    jm = JaxDeformConv(6, 3, strides=stride)
    params = {'kernel': kernel, 'conv_offset': {
        'kernel': np.zeros((3, 3, 5, 27), np.float32),
        'bias': np.zeros((27,), np.float32)}}

    def loss(p):
        y = jm.apply({'params': p}, x)
        return jnp.sum(y * cot.transpose(0, 2, 3, 1))

    jg = jax.grad(loss)(params)['conv_offset']
    j_kernel = np.asarray(jg['kernel']).transpose(3, 2, 0, 1)
    gap = np.abs(j_kernel - got[0].numpy()).max() / np.abs(got[0].numpy()).max()
    assert gap > 0.1, gap                 # the recorded departure


def _tsa_case(seed=0, h=4, w=8, c=32):
    rng = np.random.RandomState(seed)
    tsa = attention.TemporalSelfAttention(embed_dims=c)
    with torch.no_grad():
        for p in tsa.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                     * 0.2))
    attention.reset_offset_linears(tsa)
    query = torch.from_numpy(rng.randn(1, h * w, c).astype(np.float32))
    value = torch.from_numpy(rng.randn(1, 2, h * w, c).astype(np.float32))
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing='ij')
    ref = np.stack([xs, ys], -1).reshape(1, 1, h * w, 1, 2)
    ref = torch.from_numpy(np.tile(ref, (1, 2, 1, 1, 1)).astype(np.float32))
    return tsa, query, value, ref, [(h, w)]


def _msda_by_bilinear(value, shapes, loc, weights):
    """MSDA composed of ``bilinear_sample``: the other sampler."""
    b, nq, nh, nl, p, _ = loc.shape
    hd = value.shape[-1]
    out, start = 0.0, 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].reshape(b, h, w, nh, hd)
        start += h * w
        v = v.permute(0, 3, 1, 2, 4).reshape(b * nh, h, w, hd)
        # The pixel coordinate ``F.grid_sample`` computes from the port's
        # grid (``loc * 2 - 1``), op for op, so both sample the same point.
        size = torch.tensor([w, h], dtype=loc.dtype)
        pix = ((loc[:, :, :, lvl] * 2.0 - 1.0 + 1.0) * size - 1.0) / 2.0
        pix = pix.permute(0, 2, 1, 3, 4).reshape(b * nh, nq, p, 2)
        taps = bilinear_sample(v, pix)                  # (B*nh, nq, P, hd)
        wgt = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            b * nh, nq, p, 1)
        out = out + (taps * wgt).sum(2)
    return out.reshape(b, nh, nq, hd).permute(0, 2, 1, 3).reshape(
        b, nq, nh * hd)


def _tsa_offset_grads(tsa, query, value, ref, shapes, cot):
    for p in tsa.parameters():
        p.grad = None
    out = tsa(query, value, ref, shapes)
    (out * cot).sum().backward()
    return (tsa.sampling_offsets.weight.grad.clone(),
            tsa.sampling_offsets.bias.grad.clone())


def test_tsa_after_reset_both_samplers_agree(monkeypatch):
    """After ``reset_offset_linears`` the TSA taps sit on centres; the
    offset gradients through ``F.grid_sample`` and through
    ``bilinear_sample`` agree."""
    tsa, query, value, ref, shapes = _tsa_case()
    h, w = shapes[0]
    locs = []
    monkeypatch.setattr(
        attention, 'multi_scale_deformable_attn',
        lambda v, s, loc, wgt: (locs.append(loc.detach()),
                                multi_scale_deformable_attn(v, s, loc,
                                                            wgt))[1])
    cot = torch.from_numpy(np.random.RandomState(9).randn(
        1, h * w, 32).astype(np.float32))
    got = _tsa_offset_grads(tsa, query, value, ref, shapes, cot)
    pix = locs[0] * torch.tensor([w, h]) - 0.5
    on = (pix == torch.round(pix)).any(-1).float().mean()
    assert float(on) > 0.9, float(on)
    monkeypatch.setattr(attention, 'multi_scale_deformable_attn',
                        _msda_by_bilinear)
    want = _tsa_offset_grads(tsa, query, value, ref, shapes, cot)
    for g, w_, name in zip(got, want, ('weight', 'bias')):
        _assert_close(g.numpy(), w_.numpy(), TOL, f'sampling_offsets {name}')


def test_msda_on_centres_jax_departs():
    """One MSDA call with every tap on a centre: the port's location
    gradient equals the f64 one-sided difference; JAX's gather MSDA
    departs (the ROADMAP read d loc_x 10.514 against the port's 4.446 on
    such a tap)."""
    rng = np.random.RandomState(4)
    h, w, nh, hd, p = 6, 8, 2, 4, 3
    value = rng.randn(1, h * w, nh, hd).astype(np.float32)
    pix = rng.randint(-1, [w + 1, h + 1], (1, 10, nh, 1, p, 2))
    loc = ((pix + 0.5) / np.array([w, h])).astype(np.float32)
    wgt = rng.rand(1, 10, nh, 1, p).astype(np.float32)
    cot = rng.randn(1, 10, nh * hd).astype(np.float32)
    loc_t = torch.tensor(loc, requires_grad=True)
    out = multi_scale_deformable_attn(torch.from_numpy(value), [(h, w)],
                                      loc_t, torch.from_numpy(wgt))
    (out * torch.from_numpy(cot)).sum().backward()
    got = loc_t.grad.numpy()

    def f(l):
        return jnp.sum(jax_msda.multi_scale_deformable_attn(
            value[0], [(h, w)], l, wgt[0], impl='gather') * cot[0])
    jax_v = np.asarray(jax.grad(f)(jnp.asarray(loc[0])))[None]

    # f64 one-sided difference per tap, on the composed sampler.
    want = np.zeros_like(got, dtype=np.float64)
    v64 = value.reshape(h, w, nh, hd).astype(np.float64)
    for q in range(10):
        for hh in range(nh):
            for k in range(p):
                x, y = pix[0, q, hh, 0, k].astype(np.float64)
                c = cot[0, q, hh * hd:(hh + 1) * hd] * wgt[0, q, hh, 0, k]
                vv = v64[None, :, :, hh]
                base = _sample64(vv, x, y) @ c
                want[0, q, hh, 0, k, 0] = (_sample64(vv, x + 1e-6, y) @ c
                                           - base) / 1e-6 * w
                want[0, q, hh, 0, k, 1] = (_sample64(vv, x, y + 1e-6) @ c
                                           - base) / 1e-6 * h
    _assert_close(got, want, FD_TOL * 10, 'MSDA vs the one-sided difference')
    assert np.abs(jax_v - got).max() > 0.1 * np.abs(got).max()
