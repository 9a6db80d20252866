"""BEVFusion-OCC's task trunks and grid crops, port against the JAX
package on the CPU:

* one train step in f64 for the two trunk modes that own their detection
  head, 'per_task' (a BevEncode trunk per task) and 'shared' (one
  BevEncode trunk on the fused BEV), at the narrow mini configuration of
  ``tests/test_torch_port_mtl.py`` with BatchNorm biases +4: the loss and
  its parts within 1e-6, every gradient leaf within 1e-5 of its max|ref|;
* the grid crop (``bev_feature_slice``) alone in f32, value and gradient
  within 1e-5 of max|ref|, on grids that shift, refine and coarsen the
  BEV and reach outside it.  JAX's ``bilinear_sample`` cannot run with
  ``jax_enable_x64`` (its ``dynamic_slice`` mixes int32 and int64
  indices), so the train steps above use identity grids and the crop is
  held in f32, where the forward test of ``test_torch_port_mtl.py``
  also runs it.

A file of its own so that each file's JAX compiles stay near a minute and
a half on one CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.mtl import BEVFusionMTL as JaxBEVFusionMTL
from omnihd_scenes_tpu.models.mtl import (
    bev_feature_slice as jax_bev_feature_slice)
from omnihd_scenes_tpu_torch.models.mtl import BEVFusionMTL, bev_feature_slice
from tests.test_torch_port_mtl import (BEV_GRID, INPUT_KEYS,
                                       assert_steps_match, configs,
                                       f64_steps, mtl_batch)
from tests.test_torch_port_pointpillars import condition
from tests.test_torch_port_weights import random_variables

torch.set_num_threads(1)


@pytest.mark.parametrize('mode', ['per_task', 'shared'])
def test_f64_train_step(mode):
    jcfg, pcfg = configs(mode, crops=False)
    batch = mtl_batch()
    jax_model = JaxBEVFusionMTL(jcfg)
    variables = condition(random_variables(
        jax_model, *(batch[k] for k in INPUT_KEYS), train=False))
    want, got = f64_steps(jax_model, BEVFusionMTL(pcfg), 'bevfusion_mtl',
                          variables, batch, pcfg)
    assert_steps_match(want, got)
    grads = got[2]
    trunks = ('det_trunk', 'occ_trunk') if mode == 'per_task' else (
        'shared_trunk',)
    for t in trunks:
        assert float(grads[f'{t}.stem.conv.weight'].abs().max()) > 0, t
    assert float(grads['det_head.conv_cls.weight'].abs().max()) > 0
    assert not any(k.startswith('fusion.head.') for k in grads)
    assert np.isfinite(got[0])


DST_GRIDS = {
    'shift': ((-7.5, 8.5, 1.0), (-8.5, 7.5, 1.0)),
    'finer': ((-6.0, 6.0, 0.5), (-4.0, 4.0, 0.5)),
    'coarser, past the edge': ((-12.0, 12.0, 3.0), (-10.0, 10.0, 4.0)),
}


@pytest.mark.parametrize('dst', list(DST_GRIDS))
def test_grid_crop_value_and_gradient(dst):
    grid = DST_GRIDS[dst]
    rng = np.random.RandomState(3)
    bev = rng.randn(2, 16, 16, 5).astype(np.float32)        # (B, Dy, Dx, C)
    ct = rng.randn(*jax.eval_shape(
        lambda b: jax.vmap(lambda x: jax_bev_feature_slice(
            x, BEV_GRID, grid))(b), bev).shape).astype(np.float32)

    def jax_fn(b):
        out = jax.vmap(lambda x: jax_bev_feature_slice(x, BEV_GRID, grid))(b)
        return jnp.sum(out * ct), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(
        bev)
    x = torch.from_numpy(bev).permute(0, 3, 1, 2).requires_grad_(True)
    got = bev_feature_slice(x, BEV_GRID, grid)
    (got * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    for g, w in ((got, np.asarray(want)),
                 (x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grad))):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
