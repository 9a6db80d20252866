"""int8 quantizers and the fused int8 conv's plain version against the JAX
package (``omnihd_scenes_tpu/ops/qconv.py``), on the CPU.

The plain ``qconv3x3_reference`` is held to the Pallas kernel in
interpret mode and to ``tests/test_qconv.py:_xla_ref`` at that file's
shapes, with its bound: bf16 outputs within 1 ulp on under 1e-3 of the
entries (the integer sum is exact on every side; the f32 epilogue may
round once differently).  The quantizers must give bit-equal codes and
scales.  The CPU route launches no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops import qconv as jq
from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
from omnihd_scenes_tpu_torch.ops import qconv as pq
from tests.test_qconv import _xla_ref

torch.set_num_threads(1)

SHAPES = [((2, 9, 17, 128), 128, True),
          ((1, 16, 24, 256), 128, False),
          ((3, 7, 33, 128), 256, True)]


def nchw(a):
    """NHWC NumPy -> NCHW tensor view (channels_last memory)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def oihw(k):
    """HWIO NumPy kernel -> OIHW tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2))
                            ).permute(0, 3, 1, 2)


def nhwc_np(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def assert_bf16_ulp(got, want):
    g = np.asarray(got, np.float32).astype(jnp.bfloat16).view(np.uint16)
    w = np.asarray(want, np.float32).astype(jnp.bfloat16).view(np.uint16)
    ulp = np.abs(g.astype(np.int64) - w.astype(np.int64))
    assert ulp.max() <= 1, (ulp.max(), (ulp > 0).mean())
    assert (ulp > 0).mean() < 1e-3


def _case(shape, co):
    rng = np.random.RandomState(0)
    x8 = rng.randint(-127, 128, shape, dtype=np.int8)
    w8 = rng.randint(-127, 128, (3, 3, shape[-1], co), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, co).astype(np.float32)
    shift = rng.randn(co).astype(np.float32)
    return x8, w8, scale, shift


@pytest.mark.parametrize('shape,co,relu', SHAPES)
def test_reference_matches_pallas_and_xla(shape, co, relu):
    x8, w8, scale, shift = _case(shape, co)
    launches = qconv3x3.launches
    got = qconv3x3(nchw(x8), oihw(w8), torch.from_numpy(scale),
                   torch.from_numpy(shift), relu=relu)
    assert qconv3x3.launches == launches
    assert got.dtype == torch.bfloat16 and got.shape == (
        shape[0], co, *shape[1:3])
    jargs = tuple(map(jnp.asarray, (x8, w8, scale, shift)))
    pallas = jq.qconv3x3(*jargs, relu=relu, interpret=True)
    assert_bf16_ulp(nhwc_np(got), pallas)
    assert_bf16_ulp(nhwc_np(got), _xla_ref(*jargs, relu))


@pytest.mark.parametrize('shape,co,relu', SHAPES)
def test_reference_f32_is_the_exact_int_sum(shape, co, relu):
    """f32 output: the JAX int32 conv with the same f32 epilogue, within
    one f32 rounding."""
    x8, w8, scale, shift = _case(shape, co)
    got = qconv3x3(nchw(x8), oihw(w8), torch.from_numpy(scale),
                   torch.from_numpy(shift), relu=relu,
                   out_dtype=torch.float32)
    y32 = jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (1, 1), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    want = np.asarray(y32.astype(jnp.float32) * scale + shift)
    if relu:
        want = np.maximum(want, 0.0)
    np.testing.assert_allclose(nhwc_np(got), want, rtol=2.0 ** -22, atol=0)


def _edge_values(amax):
    """Values whose codes sit exactly on .5, at +-amax, beyond it, and
    random ones."""
    sx = np.float32(amax) / np.float32(127.0)
    k = np.arange(-130, 131, dtype=np.float32)
    halves = (k + np.float32(0.5)) * sx
    rng = np.random.RandomState(3)
    return np.concatenate([
        halves, k * sx, [amax, -amax, 2 * amax, -3 * amax, 0.0],
        rng.randn(997) * amax]).astype(np.float32)


def test_jitted_jax_scales_multiply_by_the_reciprocal():
    """Why the port's scales multiply by float32(1/127): under jax.jit
    (every JAX model path) XLA rewrites the JAX source's ``/ 127.0`` that
    way, and for some values that differs from eager JAX's division."""
    amax = np.random.RandomState(0).rand(4096).astype(np.float32) * 10
    jitted = np.asarray(jax.vmap(jax.jit(
        lambda a: jq.quantize_act(jnp.zeros(()), a)[1]))(amax))
    eager = amax / np.float32(127.0)
    assert (jitted != eager).any()
    port = np.array([float(pq.quantize_act(torch.zeros(()),
                                           torch.tensor(a))[1])
                     for a in amax], np.float32)
    np.testing.assert_array_equal(port, jitted)
    np.testing.assert_array_equal(port, amax * np.float32(1 / 127.0))


@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
@pytest.mark.parametrize('amax', [1.0, 3.7, 0.0])
def test_quantize_act_bit_equal(amax, dtype):
    x = _edge_values(max(amax, 1.0)).astype(dtype)
    want8, want_s = jax.jit(jq.quantize_act)(jnp.asarray(x),
                                             jnp.float32(amax))
    xt = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got8, got_s = pq.quantize_act(xt, torch.tensor(amax))
    assert got8.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()


@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
def test_quantize_weights_bit_equal(dtype):
    rng = np.random.RandomState(4)
    k = (rng.randn(3, 3, 16, 64) * 0.1).astype(np.float32)
    k[..., 0] = 0.0                                 # sw -> 1e-12
    amax = np.abs(k[..., 1]).max()                  # exact .5 codes
    k[0, 0, :5, 1] = (np.arange(5) + 0.5) * (amax / np.float32(127.0))
    k = k.astype(dtype)
    want8, want_s = jax.jit(jq.quantize_weights)(jnp.asarray(k))
    kt = torch.from_numpy(k.astype(np.float32).transpose(3, 2, 0, 1).copy())
    if dtype == jnp.bfloat16:
        kt = kt.to(torch.bfloat16)
    got8, got_s = pq.quantize_weights(kt)
    np.testing.assert_array_equal(got8.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(want8))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()


def test_qconv3x3_bn_relu_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 12, 20, 128).astype(np.float32)
    kernel = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    bn_scale = rng.uniform(0.5, 2.0, 128).astype(np.float32)
    bn_shift = (rng.randn(128) * 0.1).astype(np.float32)
    bias = (rng.randn(128) * 0.1).astype(np.float32)
    amax = np.float32(np.abs(x).max())
    want = jax.jit(lambda *a: jq.qconv3x3_bn_relu(
        *a[:5], bias=a[5], interpret=True))(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(amax),
        jnp.asarray(bn_scale), jnp.asarray(bn_shift), jnp.asarray(bias))
    got = pq.qconv3x3_bn_relu(
        nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        torch.tensor(amax), torch.from_numpy(bn_scale),
        torch.from_numpy(bn_shift), bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert_bf16_ulp(nhwc_np(got), want)
