"""The fused LSS view transform's wrapper (``kernels/lss_sample.py:
lss_sample_bev``: camera geometry in, index fields computed inside) on
CPU tensors: against the JAX f32 einsum path ``_einsum_all`` on the mini
rig of ``tests/test_lss_project.py``, batched over samples with different
rigs; its byte count against a cell-by-cell walk of the fused kernel's
reads; and the errors it raises for what it does not take.

The JAX function is given the geometry (minv, mt) that the port computes,
so that both evaluate the index math on the same f32 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops import lss_project as jax_lss
from omnihd_scenes_tpu_torch.kernels import lss_sample as kern
from omnihd_scenes_tpu_torch.ops.lss_project import (camera_geometry,
                                                     check_rotations)
from omnihd_scenes_tpu_torch.utils.rig import perturbed_rigs
from tests.test_lss_project import (BEV_START, BEV_VOXEL, FH, FW, NDEPTH, NX,
                                    NY, NZ, ROTS, SOLVE_X, TRANS)
from tests.test_torch_port_splat import C, GEOM_ARGS

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def batch():
    """Three samples: the mini rig, and two perturbed copies of it."""
    rng = np.random.RandomState(11)
    logits = rng.randn(3, 6, FH, FW, NDEPTH).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feat = rng.randn(3, 6, FH, FW, C).astype(np.float32)
    rots, trans = perturbed_rigs(ROTS, TRANS, batch=2, seed=3)
    rots = np.concatenate([ROTS[None], rots])
    trans = np.concatenate([TRANS[None], trans])
    minv, mt = camera_geometry(torch.from_numpy(rots),
                               torch.from_numpy(trans))
    return (torch.from_numpy(feat), torch.from_numpy(depth.astype(np.float32)),
            minv.contiguous(), mt.contiguous(), kern._Geom(*GEOM_ARGS))


def test_perturbed_rigs_differ_per_sample_and_stay_rotations(batch):
    *_, minv, mt, _ = batch
    assert not torch.equal(minv[1], minv[2]) and not torch.equal(minv[0],
                                                                  minv[1])
    rots, trans = perturbed_rigs(ROTS, TRANS, batch=2, seed=3)
    # rots = turn @ R: the turn is orthonormal, so the Gram matrices agree.
    gram = np.einsum('bnji,bnjk->bnik', rots.astype(np.float64),
                     rots.astype(np.float64))
    want = np.einsum('nji,njk->nik', ROTS.astype(np.float64),
                     ROTS.astype(np.float64))
    np.testing.assert_allclose(gram, np.broadcast_to(want, gram.shape),
                               rtol=1e-5, atol=1e-9)
    shift = np.abs(np.linalg.norm(trans, axis=-1)
                   - np.linalg.norm(TRANS, axis=-1))
    assert float(shift.max()) <= 0.2 * np.sqrt(3) + 1e-5
    assert float(shift.max()) > 0


@pytest.mark.parametrize('sample', [0, 1, 2], ids=['ring', 'moved-a',
                                                     'moved-b'])
def test_fused_wrapper_matches_jax_einsum(batch, sample):
    """One call over the three samples; each sample against JAX's einsum
    on that sample's own geometry, at the splat tests' 1e-5."""
    feat, depth, minv, mt, g = batch
    got = kern.lss_sample_bev(feat, depth, minv, mt, g, SOLVE_X)
    assert got.shape == (3, NY, NX, NZ, C) and got.dtype == torch.float32
    want = np.asarray(jax_lss._einsum_all(
        jnp.asarray(depth[sample].numpy()), jnp.asarray(feat[sample].numpy()),
        jnp.asarray(minv[sample].numpy()), jnp.asarray(mt[sample].numpy()),
        jax_lss._Geom(*GEOM_ARGS), SOLVE_X, None, jnp.float32))
    assert (want != 0).any(-1).mean() > 0.4, 'degenerate rig'
    np.testing.assert_allclose(got[sample].permute(2, 0, 1, 3).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_cpu_launches_nothing_and_counts_nothing(batch):
    feat, depth, minv, mt, g = batch
    before = (kern.lss_sample_bev.launches, kern.lss_sample.launches)
    got = kern.lss_sample_bev(feat, depth, minv, mt, g, SOLVE_X,
                              out_dtype=torch.bfloat16)
    got_dumped, (j, i, kd) = kern.lss_sample_bev(feat, depth, minv, mt, g,
                                                 SOLVE_X, dump=True)
    assert (kern.lss_sample_bev.launches, kern.lss_sample.launches) == before
    want = kern.lss_sample_bev_reference(feat, depth, minv, mt, g, SOLVE_X,
                                         torch.float32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(got_dumped, want)
    fields = kern.geometry_fields(minv, mt, g, SOLVE_X)
    for a, b in zip((j, i, kd), kern.cell_indices(*fields, SOLVE_X, NY, NX,
                                                  NDEPTH)):
        assert a.shape == (3, NY, NX, NZ, 6) and torch.equal(a, b)
    assert int((i >= 0).sum()) > 100


def test_cell_indices_are_the_fields_read_cell_by_cell(batch):
    """The dump layout (B, ny, nx, nz, N) against the fields, read as the
    fields-in kernel reads them."""
    _, _, minv, mt, g = batch
    fields = kern.geometry_fields(minv, mt, g, SOLVE_X)
    i_star, j_star, kd_star = (f.numpy() for f in fields)
    j, i, kd = (t.numpy() for t in kern.cell_indices(*fields, SOLVE_X, NY,
                                                     NX, NDEPTH))
    rng = np.random.RandomState(0)
    for b, y, x, z in zip(rng.randint(0, 3, 400), rng.randint(0, NY, 400),
                          rng.randint(0, NX, 400), rng.randint(0, NZ, 400)):
        for n, sx in enumerate(SOLVE_X):
            col, bg = (y, y * NX + x) if sx else (x, x * NY + y)
            wj, wkd = j_star[b, n, z, bg], kd_star[b, n, z, bg]
            wi = (i_star[b, n, wj, z, col]
                  if 0 <= wj < FH and 0 <= wkd < NDEPTH else -1)
            assert (j[b, y, x, z, n], i[b, y, x, z, n],
                    kd[b, y, x, z, n]) == (wj, wi, wkd)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_fused_bytes_count_each_gathered_element_once(batch, out_dtype):
    """``lss_sample_bev_bytes`` against a cell-by-cell walk of the fused
    kernel's reads: each gathered depth value and feature row once, the
    output once, the geometry and the coordinate tables; no index field."""
    feat, depth, minv, mt, g = batch
    fields = kern.geometry_fields(minv, mt, g, SOLVE_X)
    j, i, kd = (t.numpy() for t in kern.cell_indices(*fields, SOLVE_X, NY,
                                                     NX, NDEPTH))
    rows, values = set(), set()
    for b, y, x, z, n in zip(*np.nonzero((i >= 0) & (i < FW))):
        rows.add((b, n, j[b, y, x, z, n], i[b, y, x, z, n]))
        values.add((b, n, j[b, y, x, z, n], i[b, y, x, z, n],
                    kd[b, y, x, z, n]))
    assert len(values) > len(rows) > 100
    geometry = 4 * (3 * 6 * 12) + 4 * (FH + NX + NY + NZ)
    want = (4 * C * len(rows) + 4 * len(values)
            + 3 * NY * NX * NZ * C * out_dtype.itemsize + geometry)
    assert kern.lss_sample_bev_bytes(feat, depth, minv, mt, g, SOLVE_X,
                                     out_dtype) == want
    # The fields-in count shares the gathers and the output, and adds all
    # of j_star and kd_star and the i_star words read.
    fields_read = kern.lss_sample_bytes(feat, depth, *fields, SOLVE_X, NY,
                                        NX, out_dtype) - (want - geometry)
    assert fields_read > 8 * fields.j_star.numel()


def _bad_inputs(feat, depth, minv, mt, g):
    """(name, args, exception, message) the wrapper must refuse."""
    return [
        ('feat 4-D', (feat[0], depth, minv, mt, g, SOLVE_X), ValueError,
         'feat/depth'),
        ('depth shape', (feat, depth[:, :, :-1], minv, mt, g, SOLVE_X),
         ValueError, 'depth'),
        ('camera count', (feat, depth, minv, mt, g, SOLVE_X[:-1]),
         ValueError, 'solve_x'),
        ('minv shape', (feat, depth, minv[..., :2], mt, g, SOLVE_X),
         ValueError, 'geometry'),
        ('mt shape', (feat, depth, minv, mt[:, :, :2], g, SOLVE_X),
         ValueError, 'geometry'),
        ('geometry batch', (feat, depth, minv[:2], mt[:2], g, SOLVE_X),
         ValueError, 'geometry'),
        ('geometry dtype', (feat, depth, minv.double(), mt, g, SOLVE_X),
         TypeError, 'float32'),
        ('depth dtype', (feat, depth.double(), minv, mt, g, SOLVE_X),
         TypeError, 'differ'),
        ('geom size', (feat[:, :, :-1], depth[:, :, :-1], minv, mt, g,
                       SOLVE_X), ValueError, 'geom'),
        ('device', tuple(a.to('meta') for a in (feat, depth, minv, mt))
         + (g, SOLVE_X), ValueError, 'device'),
    ]


@pytest.mark.parametrize('case', range(10), ids=[
    'feat 4-D', 'depth shape', 'camera count', 'minv shape', 'mt shape',
    'geometry batch', 'geometry dtype', 'depth dtype', 'geom size',
    'device'])
def test_wrapper_refuses_what_it_does_not_take(batch, case):
    name, args, exc, match = _bad_inputs(*batch)[case]
    before = kern.lss_sample_bev.launches
    with pytest.raises(exc, match=match):
        kern.lss_sample_bev(*args)
    assert kern.lss_sample_bev.launches == before, name


def test_op_is_the_fused_wrapper_on_the_geometry(batch):
    """``ops.lss_project.lss_sample_bev`` (what the model calls) equals the
    wrapper on ``camera_geometry`` of the same rig, in the JAX layout."""
    from omnihd_scenes_tpu_torch.ops.lss_project import lss_sample_bev
    from tests.test_lss_project import D0, DD, H, W

    feat, depth, minv, mt, g = batch
    rots, trans = perturbed_rigs(ROTS, TRANS, batch=2, seed=3)
    got = lss_sample_bev(
        depth[1:], feat[1:], torch.from_numpy(rots), torch.from_numpy(trans),
        image_size=(H, W), depth_range=(D0, D0 + DD * NDEPTH, DD),
        bev_start=BEV_START, bev_voxel=BEV_VOXEL, bev_nx=(NX, NY, NZ),
        solve_x=SOLVE_X)
    want = kern.lss_sample_bev(feat[1:], depth[1:], minv[1:].contiguous(),
                               mt[1:].contiguous(), g, SOLVE_X)
    assert torch.equal(got, want.permute(0, 3, 1, 2, 4))


def _bad_rotations(kind):
    """Two samples of the mini rig, one camera of which is broken."""
    rots = np.repeat(ROTS[None], 2, 0).astype(np.float32)
    if kind == 'singular':
        rots[1, 3, :, 2] = 0            # a zero column: no inverse
    else:
        rots[0, 0, 1, 1] = np.nan
    return rots


@pytest.mark.parametrize('holder', ['numpy', 'tensor'])
@pytest.mark.parametrize('kind', ['singular', 'non-finite'])
def test_bad_rotation_is_refused_on_the_host(kind, holder):
    """A singular or non-finite rotation raises where the rotations are
    held on the host, in the check and in ``camera_geometry``, instead of
    silently dropping that camera's view out of the BEV grid."""
    rots = _bad_rotations(kind)
    held = rots if holder == 'numpy' else torch.from_numpy(rots)
    with pytest.raises(ValueError, match='finite and invertible'):
        check_rotations(held)
    with pytest.raises(ValueError, match='finite and invertible'):
        camera_geometry(torch.from_numpy(rots),
                        torch.from_numpy(np.repeat(TRANS[None], 2, 0)))
    check_rotations(np.repeat(ROTS[None], 2, 0))        # the rig passes
    # A tensor on another device is not read (on the card that would wait
    # for it): the serving path checks before the upload.
    check_rotations(torch.from_numpy(rots).to('meta'))


def test_predictor_refuses_a_singular_rotation_before_the_network():
    from omnihd_scenes_tpu_torch.serve.predictor import Predictor
    from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                         random_state_dict)
    from tests.test_torch_port_weights import PORT_MINI_CFG

    predictor = Predictor(PORT_MINI_CFG, random_state_dict(PORT_MINI_CFG, 5),
                          device='cpu', dtype=torch.float32)
    points, mask, imgs, rots, trans = random_request(
        np.random.RandomState(5), PORT_MINI_CFG, batch=1, n_points=100)
    rots = rots.copy()
    rots[0, 2] = 0
    with pytest.raises(ValueError, match='finite and invertible'):
        predictor(points, mask, imgs, rots, trans)
