"""``tools/get_flops.py`` and ``tools/misc.py get_params`` of the port, on
the synthetic configs:

* the parameter count equals the JAX tool's: the number its ``count``
  sums over the flax ``params`` collection of the same config's model
  initialised on the JAX package's ``example_batch_for`` batch.  JAX's
  ``count`` runs that initialisation and compiles the forward for XLA's
  cost analysis (over 20 s on one CPU core for the smallest config), so
  the test takes the collection's shapes from ``jax.eval_shape`` of the
  same ``init`` call;
* the LSS view transform (the registered op ``omnihd::lss_sample_bev``,
  opaque to ``FlopCounterMode``) is counted by its formula, two
  operations per output value and camera;
* the CLI prints the port's labels ("forward flops (convs, matmuls,
  LSS)", "hbm bytes/fwd: n/a"); ``get_params`` prints per-submodule
  counts that sum to the total;
* ``train/builder.py:example_batch_for`` gives each family's inputs.
"""

import contextlib
import io
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from omnihd_scenes_tpu.train.builder import (
    build_model_from_cfg as jax_build_model_from_cfg,
    example_batch_for as jax_example_batch_for)
from omnihd_scenes_tpu.train.config import Config as JaxConfig
from omnihd_scenes_tpu_torch.tools import get_flops, misc
from omnihd_scenes_tpu_torch.train.builder import (build_model_from_cfg,
                                                   example_batch_for)
from omnihd_scenes_tpu_torch.train.config import Config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'pillars': 'configs/synthetic/pointpillars_radar_synth.py',
           'bevfusion_occ': 'configs/synthetic/bevfusion_synth.py',
           'bevformer': 'configs/synthetic/bevformer_synth.py'}


def jax_params(path):
    """What the JAX tool's ``count`` reports as ``params``."""
    cfg = JaxConfig.fromfile(path)
    model, mtype = jax_build_model_from_cfg(cfg)
    batch = jax_example_batch_for(model, mtype, cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *batch, train=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        shapes['params']))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_params_equal_jax(name):
    path = os.path.join(ROOT, CONFIGS[name])
    info = get_flops.count(Config.fromfile(path))
    assert info['params'] == jax_params(path)
    assert info['flops'] > 0


def test_lss_op_is_counted_by_its_formula():
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS['bevfusion_occ']))
    model, mtype = build_model_from_cfg(cfg)
    model.eval()
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.omnihd.lss_sample_bev: get_flops.lss_sample_bev_flops})
    with torch.no_grad(), counter:
        model(*example_batch_for(model, mtype))
    counts = {str(k): v for k, v in
              counter.get_flop_counts()['Global'].items()}
    lss = model.cfg.fusion.lss
    # (B, ny, nx, nz, camC) outputs, each a sum over the cameras.
    assert counts['omnihd.lss_sample_bev'] == (
        2 * math.prod(lss.bev_nx) * lss.camC * lss.num_views)
    assert counter.get_total_flops() == get_flops.count(cfg)['flops']
    assert get_flops.lss_sample_bev_flops(
        (2, 6, 8, 8, 16), None, None, None, [], 0,
        out_shape=(2, 4, 5, 3, 16)) == 2 * math.prod((2, 4, 5, 3, 16)) * 6


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_cli_and_get_params_print_the_counts():
    path = os.path.join(ROOT, CONFIGS['pillars'])
    text = _printed(get_flops.main, [path, '--device', 'cpu'])
    info = get_flops.count(Config.fromfile(path))
    assert f"params: {info['params'] / 1e6:.2f} M" in text
    assert ('forward flops (convs, matmuls, LSS): '
            f"{info['flops'] / 1e9:.2f} GFLOPs") in text
    assert 'hbm bytes/fwd: n/a' in text
    text = _printed(misc.main, ['get_params', path, '--device', 'cpu'])
    rows = [line.split() for line in text.splitlines()
            if line.startswith('  ')]
    assert sum(float(r[1]) for r in rows) == pytest.approx(
        info['params'] / 1e6, abs=1e-3 * len(rows))
    assert f"Total params: {info['params'] / 1e6:.3f} M" in text


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_example_batch_for(name):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[name]))
    model, mtype = build_model_from_cfg(cfg)
    batch = example_batch_for(model, mtype)
    again = example_batch_for(model, mtype)
    for x, y in zip(batch, again):
        assert x is None and y is None or torch.equal(x, y)
    if mtype == 'bevformer':
        q = model.cfg.queue_length
        assert batch[0].shape == (1, q, model.cfg.num_cams,
                                  *model.cfg.img_hw, 3)
        assert batch[3].dtype == torch.bool
    else:
        assert batch[0].shape == (1, 20000, 8)
        assert batch[1].all()
