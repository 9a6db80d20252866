"""The port's occupancy heads, losses and eval against the JAX package on
the CPU, with inputs made by NumPy from a seed:

* ``BEVOCCHead2D`` / ``BEVOCCHead3D`` forward in f32 within 1e-3 of
  max|ref|, through the weight bridge (``OccHeadSpec``), which round-trips
  every leaf bit for bit (the 3D head's kernels are 3D convs);
* ``geo_scal_loss``, ``sem_scal_loss``, ``lovasz_softmax_loss`` and
  ``occ_head_loss`` in f64, value and gradient within 1e-6 relative, on
  targets with unknown (255) voxels, absent classes and tied errors;
* ``evaluation_semantic`` / ``summarize_occ_scores`` equal, NaN-aware;
* the JAX-free port copies equal the originals where they are plain
  NumPy (class names).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.eval import occupancy as jax_occ_eval
from omnihd_scenes_tpu.models import occ_head as jax_occ
from omnihd_scenes_tpu_torch.eval import occupancy as port_occ_eval
from omnihd_scenes_tpu_torch.models import occ_head as port_occ
from omnihd_scenes_tpu_torch.weights import (OccHeadSpec, flax_to_torch,
                                             load_state_dict, torch_to_flax)
from tests.test_torch_port_pointpillars import assert_close_gain
from tests.test_torch_port_weights import flat_paths, random_variables

torch.set_num_threads(1)

N_CLS = 12
GRID = (6, 5, 4)                   # (Dx, Dy, Dz)


def bev_input(seed=0, b=2, c=24):
    """A (B, Dy, Dx, C) BEV, f32."""
    return np.random.RandomState(seed).randn(
        b, GRID[1], GRID[0], c).astype(np.float32)


@pytest.mark.parametrize('kind', ['2d', '3d'])
def test_head_forward_and_bridge(kind):
    bev = bev_input()
    if kind == '2d':
        jax_head = jax_occ.BEVOCCHead2D(out_dim=16, dz=GRID[2],
                                        num_classes=N_CLS)
        head = port_occ.BEVOCCHead2D(24, 16, GRID[2], N_CLS)
    else:
        jax_head = jax_occ.BEVOCCHead3D(mid_dim=8, dz=GRID[2],
                                        num_classes=N_CLS)
        head = port_occ.BEVOCCHead3D(24, 8, GRID[2], N_CLS)
    variables = random_variables(jax_head, bev, seed=4)
    # Larger weights push the 2D head's pre-activations past softplus's
    # linear switch of torch (20), which the port must not take.
    variables = jax.tree.map(lambda v: v * 40.0, variables)
    spec = OccHeadSpec(kind)
    want = np.asarray(jax.jit(jax_head.apply)(variables, bev))
    load_state_dict(head, flax_to_torch(variables, spec))
    with torch.no_grad():
        got = head(torch.from_numpy(bev).permute(0, 3, 1, 2)).numpy()
    assert want.shape == (2,) + GRID + (N_CLS,)
    assert_close_gain(got, want)
    back = flat_paths(torch_to_flax(flax_to_torch(variables, spec), spec))
    orig = flat_paths(variables)
    assert set(back) == set(orig)
    for path, v in orig.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))


def test_softplus_has_no_threshold():
    x = torch.tensor([19.0, 20.5, 25.0, 40.0], dtype=torch.float64)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(port_occ.softplus(x).numpy(), want)
    # torch's own softplus goes linear above 20, which JAX's does not.
    assert not np.array_equal(torch.nn.functional.softplus(x).numpy(), want)


def occ_case(seed):
    """(logits (Dx, Dy, Dz, C) f64, target) with unknown voxels, classes
    2 and 7 absent, and a block of identical logits (tied errors)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(*GRID, N_CLS) * 2.0
    logits[:2, :2] = logits[0, 0, 0]            # 16 voxels, one logit row
    target = rng.randint(0, N_CLS, GRID)
    target[np.isin(target, (2, 7))] = 0
    target[:2, :2] = 3                           # tied errors, one label
    target[rng.uniform(size=GRID) < 0.15] = 255
    return logits, target.astype(np.int32)


LOSSES = ['geo_scal_loss', 'sem_scal_loss', 'lovasz_softmax_loss']


def _jax_value_and_grad(fn, logits, target):
    with jax.enable_x64(True):
        v, g = jax.value_and_grad(fn)(jnp.asarray(logits), jnp.asarray(target))
        return float(v), np.asarray(g)


def _port_value_and_grad(fn, logits, target):
    x = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    v = fn(x, torch.from_numpy(target))
    v.backward()
    return v.item(), x.grad.numpy()


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', LOSSES)
def test_loss_value_and_gradient(name, seed):
    logits, target = occ_case(seed)
    jv, jg = _jax_value_and_grad(getattr(jax_occ, name), logits, target)
    pv, pg = _port_value_and_grad(getattr(port_occ, name), logits, target)
    assert abs(pv - jv) <= 1e-6 * abs(jv)
    assert np.abs(pg - jg).max() <= 1e-6 * np.abs(jg).max()


@pytest.mark.parametrize('use_lovasz', [False, True])
def test_occ_head_loss(use_lovasz):
    logits, target = occ_case(2)
    with jax.enable_x64(True):
        def jfn(x):
            out = jax_occ.occ_head_loss(x, jnp.asarray(target), use_lovasz)
            return sum(out.values()), out
        (_, jout), jg = jax.value_and_grad(jfn, has_aux=True)(
            jnp.asarray(logits))
        jout = {k: float(v) for k, v in jout.items()}
        jg = np.asarray(jg)
    x = torch.tensor(logits, requires_grad=True)
    pout = port_occ.occ_head_loss(x, torch.from_numpy(target), use_lovasz)
    sum(pout.values()).backward()
    assert set(pout) == set(jout)
    for k, v in jout.items():
        assert abs(float(pout[k]) - v) <= 1e-6 * abs(v), k
    assert np.abs(x.grad.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()


def test_losses_with_only_unknown_and_free_voxels():
    """No semantic class present: the class means divide by a clipped
    count, as in JAX."""
    logits = np.random.RandomState(5).randn(*GRID, N_CLS)
    target = np.where(np.random.RandomState(6).uniform(size=GRID) < 0.5,
                      255, 0).astype(np.int32)
    for name in LOSSES:
        jv, jg = _jax_value_and_grad(getattr(jax_occ, name), logits, target)
        pv, pg = _port_value_and_grad(getattr(port_occ, name), logits,
                                      target)
        assert abs(pv - jv) <= 1e-6 * max(abs(jv), 1e-12), name
        np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-6 * max(
            np.abs(jg).max(), 1e-12))


def _eval_case(seed, n_cls=N_CLS):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, n_cls, GRID)
    pred = np.where(rng.uniform(size=GRID) < 0.6, gt,
                    rng.randint(0, n_cls, GRID))
    pred[pred == 4] = 0                           # class 4 never predicted
    gt[gt == 9] = 0                               # class 9 never in the GT
    gt[gt == 4] = 0                               # class 4 absent: NaN IoU
    return pred, gt


def test_evaluation_semantic_equals_jax():
    for seed in range(3):
        pred, gt = _eval_case(seed)
        np.testing.assert_array_equal(
            port_occ_eval.evaluation_semantic(pred, gt, N_CLS),
            jax_occ_eval.evaluation_semantic(pred, gt, N_CLS))


@pytest.mark.parametrize('names', ['default', 'generic'])
def test_summarize_occ_scores_equals_jax(names):
    scores = [jax_occ_eval.evaluation_semantic(*_eval_case(s), N_CLS)
              for s in range(3)]
    kw = ({} if names == 'default'
          else {'class_names': [f'cls_{i}' for i in range(1, N_CLS)]})
    want = jax_occ_eval.summarize_occ_scores(scores, **kw)
    got = port_occ_eval.summarize_occ_scores(scores, **kw)
    assert list(got) == list(want)
    for k, v in want.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, k
    assert np.isnan(got['large_vehicle' if names == 'default'
                        else 'cls_4'])          # class 4: no GT, no pred
    assert port_occ_eval.OCC_CLASS_NAMES == jax_occ_eval.OCC_CLASS_NAMES
