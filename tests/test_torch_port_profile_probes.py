"""The port's isolated component probes (``omnihd_scenes_tpu_torch/tools/
profile_components.py --probe``) against the JAX package's
(``omnihd_scenes_tpu/tools/profile_components.py``), on the CPU:

* the probe list is JAX's ``PROBES``, in its order;
* ``_radar_inputs`` and every probe's inputs, at the production shapes
  and batch 1, equal the arrays JAX's probe builds, bit for bit (JAX's
  probes stopped where they would start timing, their flax models'
  initialisation skipped); the splat's depth is a softmax, taken in f32 by
  each side's own library, so it is held within one bf16 step;
* ``scatter_floor``'s body equals JAX's three index ops in f32 on seeded
  indices with collisions: the statistics' scatter-add, the gather back
  and the scatter-max with its ``isfinite`` mask;
* every probe, built at a reduced size, changes its output when the carry
  changes, so its chain stays serial;
* ``--probe`` is refused with ``--int8`` or ``--train``, and runs on the
  host with ``--device cpu``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.config import LSSConfig, PointPillarsConfig
from omnihd_scenes_tpu_torch.tools import profile_components as pc

_CACHE_ENV = 'JAX_COMPILATION_CACHE_DIR'
_had_cache_env = _CACHE_ENV in os.environ
from omnihd_scenes_tpu.tools import profile_components as jpc  # noqa: E402

if not _had_cache_env:              # the JAX tool sets it when imported
    os.environ.pop(_CACHE_ENV, None)

torch.set_num_threads(1)

PILLARS = PointPillarsConfig(pillar_impl='dense', bev_hw=(32, 48),
                             voxel_size=(2.5, 2.5, 8.0))
SMALL = {
    'resnet': dict(hw=(64, 96)),
    'stem': dict(hw=(64, 96)),
    'fpnc': dict(stages=((8, 12, 512), (4, 6, 1024), (2, 3, 2048)),
                 target_hw=(16, 24)),
    'depthnet': dict(hw=(16, 24), channels=32),
    'splat': dict(cfg=LSSConfig(final_dim=(64, 96), grid=4.0)),
    'bevencode': dict(hw=(16, 24), channels=64, out_channels=32),
    'pillar_encode': dict(points=500, pillars=PILLARS),
    'pillar_encode_fold': dict(points=500, pillars=PILLARS),
    'scatter_floor': dict(points=500, pillars=PILLARS),
    'radar': dict(points=500, pillars=PILLARS),
    # The rotated NMS is slow on one core: a 64-cell head grid.
    'decode': dict(pillars=PointPillarsConfig(bev_hw=(16, 8))),
}


def test_probe_list_is_jax():
    assert list(pc.PROBES) == list(jpc.PROBES)
    assert set(SMALL) == set(pc.PROBES)


class _Captured(Exception):
    pass


class _NoInit:
    """A flax model whose ``init`` is skipped: the test wants the inputs."""

    def __init__(self, *args, **kwargs):
        pass

    def init(self, *args, **kwargs):
        return {}


@pytest.fixture
def jax_args(monkeypatch):
    """name -> the arrays JAX's probe hands its chained loop at batch 1."""
    import omnihd_scenes_tpu.models.bevfusion as bf
    import omnihd_scenes_tpu.models.fpnc as fpnc
    import omnihd_scenes_tpu.models.lss as lss
    import omnihd_scenes_tpu.models.pillar_encoders as pe
    import omnihd_scenes_tpu.models.resnet as resnet

    for module, name in ((resnet, 'ResNet'), (fpnc, 'FPNC'),
                         (lss, 'DepthNet'), (lss, 'BevEncoderConvs'),
                         (pe, 'DensePillarEncoder'), (bf, 'BEVFusion')):
        monkeypatch.setattr(module, name, _NoInit)

    def stop(fn, args, iters, batch):
        raise _Captured(args)

    monkeypatch.setattr(jpc, 'chained', stop)

    def run(name):
        with pytest.raises(_Captured) as caught:
            jpc.PROBES[name](1, 1)
        return [np.asarray(a) for a in caught.value.args[0]]
    return run


def _bits(x):
    """Exact comparable form: bf16 as its 16-bit words, else the array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if x.dtype == jnp.bfloat16:
        return x.view(np.uint16)
    return x


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _assert_equal(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_radar_inputs_equal_jax():
    for b, n in ((1, 40000), (2, 40000)):
        got = pc._radar_inputs(b)
        want = jpc._radar_inputs(b)
        assert got[0].shape == (b, n, 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


PORT_INPUTS = {
    'resnet': lambda: [_nhwc(x) for x in pc.images_input(1, 'cpu')],
    'stem': lambda: [_nhwc(x) for x in pc.images_input(1, 'cpu')],
    'fpnc': lambda: [_nhwc(x) for x in pc.fpnc_input(1, 'cpu')],
    'depthnet': lambda: [_nhwc(x).reshape(1, 6, 136, 240, 256)
                         for x in pc.depthnet_input(1, 'cpu')],
    'splat': lambda: list(pc.splat_input(1, 'cpu')),
    'bevencode': lambda: [_nhwc(x) for x in pc.bevencode_input(1, 'cpu')],
    'pillar_encode': lambda: list(pc.radar_input(1, 'cpu')),
    'pillar_encode_fold': lambda: list(pc.radar_input(1, 'cpu')),
    'scatter_floor': lambda: list(pc.scatter_floor_input(1, 'cpu')),
    'radar': lambda: list(pc.radar_input(1, 'cpu')),
    'decode': lambda: list(pc.decode_input(1, 'cpu')),
}


@pytest.mark.parametrize('name', list(PORT_INPUTS))
def test_probe_inputs_equal_jax(name, jax_args):
    want = jax_args(name)
    got = PORT_INPUTS[name]()
    assert len(got) == len(want)
    if name == 'scatter_floor':         # JAX's cells are int32, ours int64
        assert want[0].dtype == np.int32
        got[0] = got[0].to(torch.int32)
    if name == 'decode':                # JAX tiles the grid over the batch
        want[3] = want[3][0]
    if name == 'splat':
        d_got, d_want = got[0].float().numpy(), want[0].astype(np.float32)
        assert d_got.shape == d_want.shape
        step = np.abs(d_want) * 2.0 ** -7           # one bf16 step
        assert np.all(np.abs(d_got - d_want) <= step)
        assert np.mean(d_got != d_want) < 1e-3
        got, want = got[1:], want[1:]
    for g, w in zip(got, want):
        _assert_equal(g, w)


def test_scatter_floor_body_equals_jax_index_ops():
    rng = np.random.RandomState(4)
    rows, n = 96, 700
    cells = rng.randint(0, rows - 10, n)        # collisions, 10 rows empty
    cells[:40] = 7                              # one crowded cell
    stats = rng.randn(n, 4).astype(np.float32)
    stats[:, 0] = 1.0
    emb = rng.randn(n, 64).astype(np.float32)
    pmean, canvas = pc.scatter_floor_ops(
        torch.from_numpy(cells), torch.from_numpy(stats),
        torch.from_numpy(emb), rows)
    li = jnp.asarray(cells.astype(np.int32))
    sums = jnp.zeros((rows, 4), jnp.float32).at[li].add(
        jnp.asarray(stats), mode='drop')
    want_mean = np.asarray(sums[li, 1:])
    want_canvas = jnp.full((rows, 64), -jnp.inf, jnp.float32).at[li].max(
        jnp.asarray(emb), mode='drop')
    want_canvas = np.asarray(jnp.where(jnp.isfinite(want_canvas),
                                       want_canvas, 0.0))
    np.testing.assert_allclose(pmean.numpy(), want_mean, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)
    assert not canvas[rows - 10:].any()


@pytest.mark.parametrize('name', list(SMALL))
def test_probe_output_follows_the_carry(name):
    fn, args = pc.PROBES[name](1, 'cpu', **SMALL[name])
    with torch.inference_mode():
        outs = [fn(torch.tensor(c), *args) for c in (0.0, 0.0, 1.0)]
    assert all(o.dim() == 0 and o.dtype == torch.float32 for o in outs)
    assert all(bool(torch.isfinite(o)) for o in outs)
    assert float(outs[0]) == float(outs[1]) != float(outs[2])


@pytest.mark.parametrize('flag', ['--int8', '--train'])
def test_probe_is_refused_with(flag):
    with pytest.raises(SystemExit) as e:
        pc.main(['--probe', '--device', 'cpu', flag])
    assert e.value.code == 2


def test_probe_cli_on_the_host(capsys):
    records = pc.main(['--probe', 'scatter_floor,pillar_encode', '--batch',
                       '1', '--iters', '1', '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('cpu')
    printed = [json.loads(line) for line in lines[1:]]
    assert printed == records
    assert [r['probe'] for r in records] == ['scatter_floor',
                                             'pillar_encode']
    for r in records:
        assert {'probe', 'batch', 'ms_per_sample', 'ms_per_iter'} <= set(r)
        assert r['batch'] == 1 and r['ms_per_sample'] > 0
        assert r['launches'] == {}          # no kernel launches on the host
