"""The port's deformable-attention sampling (``ops/ms_deform_attn.py``)
against the JAX package's gather form, on the CPU in f32.

* ``bilinear_sample``: grid_sample semantics (pixel centres, zero taps
  outside the map) at interior points, on the borders, wholly outside,
  and on maps of height or width 1 (the JAX form pads them to 2);
* ``multi_scale_deformable_attn`` (``F.grid_sample`` per level) against
  JAX's ``impl='gather'`` over two levels, one of them 1 x W, with
  locations past every border;
* chunked against unchunked: the same numbers, chunk by chunk;
* bf16 values: sampled in f32 (positions f32), equal to the f32 path on
  the bf16-rounded values, rounded once;
* each call counts one.

Bound: 1e-4 of max|ref| (the two forms differ in rounding only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnihd_scenes_tpu.ops import ms_deform_attn as jax_msda
from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
    bilinear_sample, multi_scale_deformable_attn)

torch.set_num_threads(1)
TOL = 1e-4


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize('hw', [(5, 7), (1, 6), (6, 1), (1, 1)])
def test_bilinear_sample_matches_jax(hw):
    rng = np.random.RandomState(sum(hw))
    h, w = hw
    value = rng.randn(2, h, w, 3).astype(np.float32)
    # Interior points, the four borders (x, y in {-0.5, size - 0.5}),
    # points up to 1.5 texels outside, and exact texel centres.
    loc = np.concatenate([
        rng.uniform(-2.0, [w + 1.0, h + 1.0], (2, 40, 2)),
        np.tile(np.array([[-0.5, -0.5], [w - 0.5, h - 0.5],
                          [-0.5, h - 0.5], [w - 0.5, -0.5],
                          [0.0, 0.0], [w - 1.0, h - 1.0],
                          [-1.0, 0.3], [w, h]], np.float32), (2, 1, 1)),
    ], 1).astype(np.float32)
    want = jax.vmap(jax_msda.bilinear_sample)(value, loc)
    got = bilinear_sample(torch.from_numpy(value), torch.from_numpy(loc))
    assert_close(got.numpy(), want)


def _msda_inputs(seed, b=2, nq=50, nh=4, hd=8, p=3,
                 shapes=((6, 9), (1, 5))):
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, nh, hd).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, nq, nh, len(shapes), p, 2)).astype(
        np.float32)
    logits = rng.randn(b, nq, nh, len(shapes) * p)
    wgt = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    wgt = wgt.reshape(b, nq, nh, len(shapes), p).astype(np.float32)
    return value, shapes, loc, wgt


@pytest.mark.parametrize('seed', [0, 1])
def test_msda_matches_jax_gather(seed):
    value, shapes, loc, wgt = _msda_inputs(seed)
    want = jax.vmap(lambda v, l, a: jax_msda.multi_scale_deformable_attn(
        v, shapes, l, a, impl='gather'))(value, loc, wgt)
    got = multi_scale_deformable_attn(
        torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(wgt))
    assert_close(got.numpy(), want)


def test_msda_chunked_equals_unchunked():
    value, shapes, loc, wgt = [
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in _msda_inputs(3, nq=61)]
    whole = multi_scale_deformable_attn(value, shapes, loc, wgt)
    for chunk in (7, 60, 61, 256):
        torch.testing.assert_close(
            multi_scale_deformable_attn(value, shapes, loc, wgt,
                                        query_chunk=chunk),
            whole, rtol=0, atol=0)
    # JAX's own chunked gather (lax.map over query chunks) agrees too.
    want = jax.vmap(lambda v, l, a: jax_msda.multi_scale_deformable_attn(
        v, shapes, l, a, query_chunk=16, impl='gather'))(
            value.numpy(), loc.numpy(), wgt.numpy())
    assert_close(whole.numpy(), want)


def test_msda_bf16_samples_in_f32():
    value, shapes, loc, wgt = [
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in _msda_inputs(4, shapes=((40, 60),))]
    v16 = value.bfloat16()
    got = multi_scale_deformable_attn(v16, shapes, loc, wgt.bfloat16())
    want = multi_scale_deformable_attn(v16.float(), shapes, loc,
                                       wgt.bfloat16().float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_msda_counts_calls():
    value, shapes, loc, wgt = [
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in _msda_inputs(5, nq=10)]
    before = multi_scale_deformable_attn.calls
    multi_scale_deformable_attn(value, shapes, loc, wgt, query_chunk=3)
    assert multi_scale_deformable_attn.calls == before + 1
