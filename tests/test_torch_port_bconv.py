"""The fused bf16 dilated conv's plain version against the JAX package
(``omnihd_scenes_tpu/ops/bconv.py``), on the CPU, at the shapes and
dilations of ``tests/test_bconv.py``.

Both sides take bf16 inputs and sum in f32, in different orders, then
round to bf16.  Bound: within 1 bf16 ulp of the JAX value, plus 1e-5 *
max|ref| where the sum cancels near zero (an f32 sum-order error there is
many ulps of a tiny value).  The CPU route launches no kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.ops.bconv import (bconv3x3 as jax_bconv3x3,
                                         bconv3x3_reference as jax_reference)
from omnihd_scenes_tpu_torch.kernels.bconv import bconv3x3
from tests.test_torch_port_qconv import nchw, nhwc_np, oihw

torch.set_num_threads(1)


def assert_within_bf16_ulp(got, want):
    want = np.asarray(want, np.float32)
    _, exp = np.frexp(want)
    ulp = np.ldexp(np.float32(1.0), exp - 8).astype(np.float32)
    slack = np.abs(np.asarray(got, np.float32) - want) - ulp
    assert slack.max() <= 1e-5 * np.abs(want).max(), slack.max()


def _case(shape, dilation, co=128):
    rng = np.random.RandomState(dilation * 10 + shape[1])
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, shape[-1], co) * 0.05).astype(np.float32)
    scale = (rng.rand(co) + 0.5).astype(np.float32)
    shift = (rng.randn(co) * 0.1).astype(np.float32)
    return x, k, scale, shift


@pytest.mark.parametrize('dilation', [1, 2, 6])
@pytest.mark.parametrize('shape', [(2, 16, 24, 128), (1, 8, 40, 256)])
def test_reference_matches_jax(shape, dilation):
    x, k, scale, shift = _case(shape, dilation)
    launches = bconv3x3.launches
    got = bconv3x3(nchw(x).to(torch.bfloat16), oihw(k).to(torch.bfloat16),
                   torch.from_numpy(scale), torch.from_numpy(shift),
                   dilation=dilation)
    assert bconv3x3.launches == launches
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], 128, *shape[1:3])
    jargs = tuple(map(jnp.asarray, (x, k, scale, shift)))
    got = nhwc_np(got)
    assert_within_bf16_ulp(got, jax_reference(*jargs, dilation=dilation))
    assert_within_bf16_ulp(got, jax_bconv3x3(*jargs, dilation=dilation,
                                             interpret=True))


def test_no_relu_and_defaults():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 16, 128).astype(np.float32)
    k = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    got = nhwc_np(bconv3x3(nchw(x), oihw(k), relu=False))
    assert (got < 0).any()
    assert_within_bf16_ulp(got, jax_reference(jnp.asarray(x), jnp.asarray(k),
                                              relu=False))
