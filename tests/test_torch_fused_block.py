"""Kernel B1 of the PyTorch port against the JAX package's Pallas kernel.

The port's ``conv_fwd`` on CPU tensors (its plain version) is held to the
JAX ``conv_fwd`` run in Pallas interpret mode, on the same seeded numpy
inputs: k in {1, 3} x stride in {1, 2}, with no prologue and with the
BN-apply prologue (nonzero bias, so a border tap that padded x before the
prologue would show up), ReLU on and off, with and without the stats
epilogue, Ci != Co, odd H at stride 1 and forced multi-row-tile grids.
``bottleneck_infer`` is held to the JAX one for a dim-match unit and for
downsample units at stride 1 and 2.

The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX
calls ``pltpu.CompilerParams``; each test sets that alias with
``monkeypatch`` and undoes it afterwards.

Tolerances: fp32 on both sides, rtol 1e-4 / atol 1e-5 (summation order
only; weights are scaled by 1/sqrt(fan-in) so outputs are O(1)). The
stats are sums over every pixel: each channel's sum is held within 1e-4
of that channel's sum of |y| (and the sum of squares within 1e-4 of
itself).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.kernels import fused_block as jfb
from mxnet_tpu_torch.kernels import fused_block as tfb

RTOL, ATOL, STATS_TOL = 1e-4, 1e-5, 1e-4
EPS = 2e-5


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _arrays(seed, n, h, ci, co, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    scale = (rng.rand(ci) + 0.5).astype(np.float32)
    bias = (rng.randn(ci) * 0.5 + 0.3).astype(np.float32)
    return x, w, scale, bias


def _both(x, w, scale, bias, stride, pro, emit):
    jpro = tpro = None
    if pro is not None:
        jpro = (jnp.asarray(scale), jnp.asarray(bias), pro)
        tpro = (torch.tensor(scale), torch.tensor(bias), pro)
    jy, jst = jfb.conv_fwd(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           prologue=jpro, emit_stats=emit, interpret=True)
    ty, tst = tfb.conv_fwd(torch.tensor(x), torch.tensor(w), stride=stride,
                           prologue=tpro, emit_stats=emit)
    return np.asarray(jy), jst, ty.numpy(), tst


def _check_stats(jst, tst, y):
    jst = np.asarray(jst)
    tst = tst.numpy()
    assert tst.shape == jst.shape == (2, y.shape[-1])
    abs_sum = np.abs(y).sum(axis=(0, 1, 2))
    assert np.all(np.abs(tst[0] - jst[0]) <= STATS_TOL * abs_sum)
    assert np.all(np.abs(tst[1] - jst[1]) <= STATS_TOL * jst[1])


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("pro", [None, True, False],
                         ids=["plain", "bn-relu", "bn"])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv_fwd_matches_pallas(k, stride, pro, emit):
    x, w, scale, bias = _arrays(k * 10 + stride, 2, 8, 8, 16, k)
    jy, jst, ty, tst = _both(x, w, scale, bias, stride, pro, emit)
    assert ty.shape == jy.shape == (2, 8 // stride, 8 // stride, 16)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    if emit:
        _check_stats(jst, tst, ty)
    else:
        assert jst is None and tst is None


@pytest.mark.parametrize("k", [1, 3])
def test_conv_fwd_odd_height_stride1(k):
    x, w, scale, bias = _arrays(7 + k, 3, 7, 16, 8, k)
    jy, jst, ty, tst = _both(x, w, scale, bias, 1, True, True)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    _check_stats(jst, tst, ty)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_conv_fwd_multi_tile(monkeypatch, k, stride):
    """Two-row tiles force halo rows across the Pallas grid's tiles."""
    monkeypatch.setattr(jfb, "ROW_TILE", 2)
    x, w, scale, bias = _arrays(30 + k + stride, 2, 16, 8, 24, k)
    jy, jst, ty, tst = _both(x, w, scale, bias, stride, True, True)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    _check_stats(jst, tst, ty)


@pytest.mark.parametrize("k", [1, 3])
def test_odd_spatial_stride2_raises_in_both(k):
    x, w, _scale, _bias = _arrays(0, 1, 7, 8, 8, k)
    with pytest.raises(ValueError, match="stride-2 requires even"):
        jfb.conv_fwd(jnp.asarray(x), jnp.asarray(w), stride=2,
                     interpret=True)
    with pytest.raises(ValueError, match="stride-2 requires even"):
        tfb.conv_fwd(torch.tensor(x), torch.tensor(w), stride=2)


def _unit_args(seed, stride, dim_match, n=2, h=8, ci=16, c=8):
    co = ci if dim_match and stride == 1 else 32
    rng = np.random.RandomState(seed)

    def conv(k, i, o):
        return (rng.randn(k, k, i, o) / np.sqrt(k * k * i)).astype(np.float32)

    def vec(ch, lo, hi):
        return rng.uniform(lo, hi, ch).astype(np.float32)

    args = [rng.randn(n, h, h, ci).astype(np.float32), conv(1, ci, c),
            conv(3, c, c), conv(1, c, co),
            None if dim_match else conv(1, ci, co)]
    for ch in (ci, c, c):                      # gamma, beta per BN
        args += [vec(ch, 0.5, 1.5), vec(ch, -0.5, 0.5)]
    for ch in (ci, c, c):                      # moving mean, var per BN
        args += [vec(ch, -0.3, 0.3), vec(ch, 0.5, 2.0)]
    return args


@pytest.mark.parametrize("stride,dim_match", [(1, True), (1, False),
                                              (2, False)])
def test_bottleneck_infer_matches_jax(stride, dim_match):
    args = _unit_args(stride * 2 + dim_match, stride, dim_match)
    jout = jfb.bottleneck_infer(
        *[None if a is None else jnp.asarray(a) for a in args],
        stride=stride, eps=EPS, interpret=True)
    tout = tfb.bottleneck_infer(
        *[None if a is None else torch.tensor(a) for a in args],
        stride=stride, eps=EPS)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_conv_fwd_counts_only_kernel_launches():
    """On the CPU the plain version runs and the launch count stays."""
    x, w, scale, bias = _arrays(5, 1, 4, 8, 8, 3)
    before = tfb.conv_fwd.launches
    tfb.conv_fwd(torch.tensor(x), torch.tensor(w),
                 prologue=(torch.tensor(scale), torch.tensor(bias), True))
    assert tfb.conv_fwd.launches == before


def test_meta_tensors_give_shapes_without_compute():
    x = torch.empty(2, 8, 8, 16, device="meta")
    w = torch.empty(3, 3, 16, 32, device="meta")
    y, st = tfb.conv_fwd(x, w, stride=2, emit_stats=True)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 4, 4, 32)
    assert tuple(st.shape) == (2, 32)
