"""The port's ``Pooling`` against the JAX package's, on the CPU.

The same numpy-seeded NCHW input goes through ``mxnet_tpu.ops.nn.pooling``
and ``mxnet_tpu_torch.ops.nn.pooling``: max, avg and sum; global and
windowed; kernels 2 and 3 with pads 0 to 2 (a pad above half the kernel
included, which torch's own pools refuse); strides 1 and 2. fp32 on both
sides, so only the order of the window sums differs: rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu_torch.ops import nn as torch_nn

RTOL, ATOL = 1e-4, 1e-5
POOLS = ("max", "avg", "sum")


def _both(x, **attrs):
    want = np.asarray(jax_nn.pooling(jnp.asarray(x), **attrs))
    got = torch_nn.pooling(torch.from_numpy(x), **attrs).numpy()
    return got, want


@pytest.mark.parametrize("pool_type", POOLS)
@pytest.mark.parametrize("shape", [(2, 3, 7, 7), (1, 4, 6, 5)])
def test_global_pool_matches_jax(pool_type, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, want = _both(x, kernel=(1, 1), pool_type=pool_type,
                      global_pool=True)
    assert got.shape == want.shape == shape[:2] + (1, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool_type", POOLS)
@pytest.mark.parametrize("kernel", [2, 3])
@pytest.mark.parametrize("pad", [0, 1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_windowed_pool_matches_jax(pool_type, kernel, pad, stride):
    rng = np.random.RandomState(kernel * 100 + pad * 10 + stride)
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    got, want = _both(x, kernel=(kernel, kernel), pool_type=pool_type,
                      stride=(stride, stride), pad=(pad, pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("kernel, want_hw", [(2, 9), (3, 8)])
def test_pad_above_half_the_kernel(pool_type, kernel, want_hw):
    """The two shapes the port used to refuse: (1, 2, 6, 6), stride 1, pad
    2, kernel 2 -> 9x9 and kernel 3 -> 8x8."""
    x = np.random.RandomState(kernel).randn(1, 2, 6, 6).astype(np.float32)
    got, want = _both(x, kernel=(kernel, kernel), pool_type=pool_type,
                      stride=(1, 1), pad=(2, 2))
    assert got.shape == want.shape == (1, 2, want_hw, want_hw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
