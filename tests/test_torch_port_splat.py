"""LSS sampling view transform: the port's index fields and splat against
``omnihd_scenes_tpu/ops/lss_project.py`` (f32 einsum path), on the
6-camera rig of ``tests/test_lss_project.py``.

The index fields come from ``round()`` of f32 projections, and torch and
XLA may order float operations (and invert the 3x3 rotations)
differently, so the fields are compared with a mismatch bound, and the
splat math is compared on shared JAX-computed fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops import lss_project as jax_lss
from omnihd_scenes_tpu_torch.kernels.lss_sample import (lss_sample,
                                                        lss_sample_bytes,
                                                        lss_sample_reference)
from omnihd_scenes_tpu_torch.ops import lss_project as port_lss
from tests.test_lss_project import (BEV_START, BEV_VOXEL, D0, DD, FH, FW, H,
                                    NDEPTH, NX, NY, NZ, ROTS, SOLVE_X, TRANS,
                                    W)

torch.set_num_threads(1)

C = 6
DEPTH_RANGE = (D0, D0 + DD * NDEPTH, DD)
GEOM_ARGS = ((H, W), (FH, FW), DEPTH_RANGE, BEV_START, BEV_VOXEL,
             (NX, NY, NZ))


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.RandomState(7)
    logits = rng.randn(6, FH, FW, NDEPTH).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feat = rng.randn(6, FH, FW, C).astype(np.float32)
    return depth.astype(np.float32), feat


@pytest.fixture(scope='module')
def jax_geometry():
    minv = jnp.linalg.inv(jnp.asarray(ROTS))
    mt = -jnp.einsum('nij,nj->ni', minv, jnp.asarray(TRANS))
    return minv, mt, jax_lss._Geom(*GEOM_ARGS)


def _jax_fields(jax_geometry):
    """Per-camera JAX-layout fields as torch tensors with a batch dim."""
    minv, mt, g = jax_geometry
    return [tuple(torch.from_numpy(np.array(a))[None] for a in
                  jax_lss._sample_indices(minv[n], mt[n], sx, g))
            for n, sx in enumerate(SOLVE_X)]


def _einsum_ref(depth, feat, jax_geometry):
    minv, mt, g = jax_geometry
    return np.asarray(jax_lss._einsum_all(
        jnp.asarray(depth), jnp.asarray(feat), minv, mt, g, SOLVE_X, None,
        jnp.float32))


@pytest.mark.parametrize('solve_x', [True, False], ids=['front', 'side'])
def test_index_fields_match_jax(solve_x, jax_geometry):
    """>= 99.9% of entries equal; every mismatch within +-1 or at a
    validity edge (one side -1)."""
    minv, mt, g = jax_geometry
    pminv, pmt = port_lss.camera_geometry(torch.from_numpy(ROTS),
                                          torch.from_numpy(TRANS))
    cams = [n for n, s in enumerate(SOLVE_X) if s == solve_x]
    assert cams
    got = port_lss._sample_indices(pminv[cams], pmt[cams], solve_x,
                                   port_lss._Geom(*GEOM_ARGS))
    n_b, n_g = (NY, NX) if solve_x else (NX, NY)
    assert got[0].shape == (len(cams), FH, NZ, n_b)
    assert got[1].shape == got[2].shape == (len(cams), NZ, n_b, n_g)
    total = mismatched = 0
    for k, n in enumerate(cams):
        want = jax_lss._sample_indices(minv[n], mt[n], solve_x, g)
        for w, t in zip(want, got):
            w, t = np.asarray(w), t[k].numpy()
            bad = w != t
            total += w.size
            mismatched += int(bad.sum())
            near = (np.abs(w - t) <= 1) | (w == -1) | (t == -1)
            assert near[bad].all()
        assert (np.asarray(want[1]) >= 0).any(), 'no valid cell'
    assert mismatched <= 1e-3 * total, (mismatched, total)


def test_plain_splat_matches_einsum(inputs, jax_geometry):
    depth, feat = inputs
    fields = port_lss.pack_fields(_jax_fields(jax_geometry),
                                  port_lss._Geom(*GEOM_ARGS))
    got = lss_sample(torch.from_numpy(feat)[None],
                     torch.from_numpy(depth)[None], *fields, solve_x=SOLVE_X,
                     ny=NY, nx=NX)
    assert got.shape == (1, NY, NX, NZ, C) and got.dtype == torch.float32
    want = _einsum_ref(depth, feat, jax_geometry)
    assert (want != 0).any(-1).mean() > 0.5, 'degenerate rig'
    np.testing.assert_allclose(got[0].permute(2, 0, 1, 3).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_lss_sample_bev_matches_einsum(inputs, jax_geometry):
    """The whole port path (its own index fields) against JAX, batched
    over two samples, in the JAX per-sample layout."""
    depth, feat = inputs
    t = torch.from_numpy
    got = port_lss.lss_sample_bev(
        t(np.stack([depth, depth[::-1]])), t(np.stack([feat, feat[::-1]])),
        t(np.stack([ROTS] * 2)), t(np.stack([TRANS] * 2)),
        image_size=(H, W), depth_range=DEPTH_RANGE, bev_start=BEV_START,
        bev_voxel=BEV_VOXEL, bev_nx=(NX, NY, NZ), solve_x=SOLVE_X)
    assert got.shape == (2, NZ, NY, NX, C)
    np.testing.assert_allclose(got[0].numpy(),
                               _einsum_ref(depth, feat, jax_geometry),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got[1].numpy(),
        _einsum_ref(depth[::-1], feat[::-1], jax_geometry),
        rtol=1e-5, atol=1e-5)


def test_out_of_range_depth_bins_contribute_nothing(inputs, jax_geometry):
    """kd >= D (no upper bound from the index math) and kd = -1 both drop
    the camera, as the einsum's one-hot does."""
    depth, feat = inputs
    per_camera = _jax_fields(jax_geometry)
    fields = port_lss.pack_fields(per_camera, port_lss._Geom(*GEOM_ARGS))
    kd = fields.kd_star.clone()
    valid = (fields.j_star >= 0) & (kd >= 0)
    assert valid.sum() > 100
    flat = torch.nonzero(valid.flatten())[:, 0]
    over, neg = flat[::3], flat[1::3]
    kd.view(-1)[over] = NDEPTH + torch.arange(len(over),
                                              dtype=torch.int32) % 7
    kd.view(-1)[neg] = -1
    t = torch.from_numpy
    got = lss_sample(t(feat)[None], t(depth)[None], fields.i_star,
                     fields.j_star, kd, solve_x=SOLVE_X, ny=NY, nx=NX)

    # Reference: the einsum with the same fields, per camera.
    want = np.zeros((NZ, NY, NX, C), np.float32)
    kd_cam = kd[0].reshape(len(SOLVE_X), NZ, -1)
    for n, sx in enumerate(SOLVE_X):
        i, j, _ = (np.asarray(a[0]) for a in per_camera[n])
        n_b, n_g = (NY, NX) if sx else (NX, NY)
        k = kd_cam[n].reshape(NZ, n_b, n_g).numpy()
        out = np.asarray(jax_lss._variant_einsum(
            jnp.concatenate([feat[n], depth[n]], -1), i, j, k, C, NDEPTH,
            jnp.float32))
        want += out if sx else out.transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got[0].permute(2, 0, 1, 3).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # ... and the dropped entries really were live before.
    full = lss_sample(t(feat)[None], t(depth)[None], *fields,
                      solve_x=SOLVE_X, ny=NY, nx=NX)
    assert not torch.equal(full, got)


def test_wrapper_checks_shapes(inputs):
    depth, feat = inputs
    t = torch.from_numpy
    g = port_lss._Geom(*GEOM_ARGS)
    fields = port_lss.sample_fields(t(ROTS)[None], t(TRANS)[None], g, SOLVE_X)
    with pytest.raises(ValueError, match='solve_x'):
        lss_sample(t(feat)[None], t(depth)[None], *fields,
                   solve_x=SOLVE_X[:-1], ny=NY, nx=NX)
    with pytest.raises(ValueError, match='j_star'):
        lss_sample(t(feat)[None], t(depth)[None], *fields, solve_x=SOLVE_X,
                   ny=NX, nx=NY + 1)
    with pytest.raises(ValueError, match='depth'):
        lss_sample(t(feat)[None], t(depth)[None, :, :-1], *fields,
                   solve_x=SOLVE_X, ny=NY, nx=NX)
    meta = [x.to('meta') for x in (t(feat)[None], t(depth)[None], *fields)]
    with pytest.raises(ValueError, match='device'):
        lss_sample(*meta, solve_x=SOLVE_X, ny=NY, nx=NX)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_needed_bytes_count_each_gathered_element_once(inputs, out_dtype):
    """``lss_sample_bytes`` against a cell-by-cell walk of the kernel's
    reads (``csrc/lss_sample.cu``), with each element counted once."""
    depth, feat = inputs
    t = torch.from_numpy
    g = port_lss._Geom(*GEOM_ARGS)
    fields = port_lss.sample_fields(t(ROTS)[None], t(TRANS)[None], g, SOLVE_X)
    i_star, j_star, kd_star = (f[0].numpy() for f in fields)
    words, rows, values = set(), set(), set()
    for n, sx in enumerate(SOLVE_X):
        for z, y, x in np.ndindex(NZ, NY, NX):
            col, bg = (y, y * NX + x) if sx else (x, x * NY + y)
            j, kd = j_star[n, z, bg], kd_star[n, z, bg]
            if not (0 <= j < FH and 0 <= kd < NDEPTH):
                continue
            words.add((n, j, z, col))
            i = i_star[n, j, z, col]
            if 0 <= i < FW:
                rows.add((n, j, i))
                values.add((n, j, i, kd))
    assert len(values) > len(rows) > 100
    want = (4 * (j_star.size + kd_star.size) + 4 * len(words)
            + 4 * C * len(rows) + 4 * len(values)
            + NY * NX * NZ * C * out_dtype.itemsize)
    assert lss_sample_bytes(t(feat)[None], t(depth)[None], *fields, SOLVE_X,
                            NY, NX, out_dtype) == want


def test_cpu_calls_the_plain_version_and_counts_nothing(inputs):
    depth, feat = inputs
    t = torch.from_numpy
    g = port_lss._Geom(*GEOM_ARGS)
    fields = port_lss.sample_fields(t(ROTS)[None], t(TRANS)[None], g, SOLVE_X)
    before = lss_sample.launches
    got = lss_sample(t(feat)[None], t(depth)[None], *fields,
                     solve_x=SOLVE_X, ny=NY, nx=NX, out_dtype=torch.bfloat16)
    assert lss_sample.launches == before
    want = lss_sample_reference(t(feat)[None], t(depth)[None], *fields,
                                SOLVE_X, NY, NX, torch.float32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
