"""Fused ResNet training in the PyTorch port against the JAX package, on the
CPU at a small size.

- B2 ``conv_wgrad`` and B3 ``conv_dgrad``: the port's plain versions (what
  the wrappers run on CPU tensors) against the JAX Pallas kernels in
  interpret mode, over k, stride, the x-side prologue, the g side whole or
  rebuilt from (e, y_raw) by the BN backward, the mask-and-stats epilogue
  and the shortcut's ``extra`` term, with a nonzero BN bias so that a wrong
  border shows; again with the JAX kernels on 2-row tiles, so that halos
  cross tiles.
- ``bottleneck_train``: forward, batch statistics and every autograd
  gradient against ``jax.grad`` of the JAX ``bottleneck_train``, and
  against the port's own unfused composition through ``F.conv2d``.
- ``SoftmaxOutput``'s loss gradient against the JAX ``custom_vjp``; the
  training ``BatchNorm``'s data gradient against ``jax.grad``.
- The training graph closure, ``TrainStep.init_params`` (bit-identical),
  three ``TrainStep`` steps against JAX's ``TrainStep(mesh=None)`` in fp32
  and in bf16, fused against unfused in the port, the unported options
  (mesh, ZeRO; the others are held in tests/test_torch_train_options.py),
  the default device and the launch counters.

Tolerances: fp32 on both sides, ``rtol 1e-4`` and an ``atol`` of 1e-5 of
the reference's largest |value| (summation order only). The batch
statistics of B3 are sums over every pixel: each channel within 1e-4 of
that channel's sum of |terms|. Others are stated where they are used.

The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX
calls ``pltpu.CompilerParams``; each test sets that alias with
``monkeypatch`` and undoes it afterwards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.executor import _graph_closure as jax_graph_closure
from mxnet_tpu.kernels import fused_block as jfb
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.parallel import spmd as jspmd
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _graph_closure
from mxnet_tpu_torch.kernels import fused_block as tfb
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import TrainStep

RTOL, ATOL = 1e-4, 1e-5
EPS = 2e-5
TINY = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
SHAPES = {"data": (4, 3, 64, 64), "softmax_label": (4,)}
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
# The batch's seed. A pre-activation within an ulp of 0 takes its ReLU
# mask one way in one package and the other way in the other (their f32
# sums run in other orders), and one such element moves its channel's
# beta gradient by a few percent (one term of a 1024-term sum). This batch
# crosses no such boundary in three steps of either package.
BATCH_SEED = 4


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# B2 and B3 against the Pallas kernels
# ---------------------------------------------------------------------------
def _conv_case(seed, n, h, ci, co, k, stride):
    """x, w, a BN prologue (nonzero bias), e and y_raw at the output, and
    the 5 BN-backward constants, in numpy fp32."""
    rng = np.random.RandomState(seed)
    ho = h // stride
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    scale = (rng.rand(ci) + 0.5).astype(np.float32)
    bias = (rng.randn(ci) * 0.5 + 0.3).astype(np.float32)
    e = rng.randn(n, ho, ho, co).astype(np.float32)
    y = (rng.randn(n, ho, ho, co) * 1.5 + 0.2).astype(np.float32)
    consts = [(rng.rand(co) + 0.5), rng.randn(co) * 0.2, rng.rand(co) + 0.5,
              rng.randn(co) * 0.1, rng.randn(co) * 0.1]
    return x, w, (scale, bias), e, y, [c.astype(np.float32) for c in consts]


def _wgrad_both(k, stride, pro, bnbwd, seed=0, h=8, n=2, ci=8, co=16):
    x, w, (scale, bias), e, y, consts = _conv_case(seed, n, h, ci, co, k,
                                                   stride)
    jkw = dict(stride=stride, interpret=True)
    tkw = dict(stride=stride)
    if pro is not None:
        jkw["x_prologue"] = (_j(scale), _j(bias), pro)
        tkw["x_prologue"] = (_t(scale), _t(bias), pro)
    if bnbwd:
        jg, tg = (_j(e), _j(y)), (_t(e), _t(y))
        jkw["g_bnbwd"] = tuple(_j(c) for c in consts)
        tkw["g_bnbwd"] = tuple(_t(c) for c in consts)
    else:
        jg, tg = _j(e), _t(e)
    want = jfb.conv_wgrad(_j(x), jg, w.shape, **jkw)
    got = tfb.conv_wgrad(_t(x), tg, w.shape, **tkw)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


def _k_stride_cases(ragged):
    """(k, stride, shape) cases: the four (k, stride) pairs at the default
    shape, then the tensor-core kernels' ragged card-test shapes (n, h, ci,
    co): 7x7 at batch 1 and 2, Ci and Co of 8 and 72."""
    return [pytest.param(k, s, None, id="%d-%d" % (k, s))
            for k, s in ((1, 1), (1, 2), (3, 1), (3, 2))] + [
        pytest.param(k, s, shape, id="%d-%d-%s" % (
            k, s, "x".join(map(str, shape)))) for k, s, shape in ragged]


RAGGED_WGRAD = [(3, 1, (1, 7, 72, 8)), (1, 1, (2, 7, 8, 72)),
                (3, 2, (1, 14, 72, 72))]
RAGGED_DGRAD = RAGGED_WGRAD + [(1, 2, (2, 14, 8, 8))]


def _shape_kw(shape):
    if shape is None:
        return {}
    n, h, ci, co = shape
    return dict(n=n, h=h, ci=ci, co=co)


@pytest.mark.parametrize("bnbwd", [False, True], ids=["g", "bnbwd"])
@pytest.mark.parametrize("pro", [None, True, False],
                         ids=["plain", "bn-relu", "bn"])
@pytest.mark.parametrize("k,stride,shape", _k_stride_cases(RAGGED_WGRAD))
def test_conv_wgrad_matches_pallas(k, stride, shape, pro, bnbwd):
    _wgrad_both(k, stride, pro, bnbwd, seed=k * 10 + stride,
                **_shape_kw(shape))


def _dgrad_both(k, stride, bnbwd, mask, s2=None, seed=0, h=8, n=2, ci=8,
                co=16, co2=24):
    x, w, _pro, e, y, consts = _conv_case(seed, n, h, ci, co, k, stride)
    rng = np.random.RandomState(seed + 100)
    jkw = dict(stride=stride, interpret=True)
    tkw = dict(stride=stride)
    if bnbwd:
        jg, tg = (_j(e), _j(y)), (_t(e), _t(y))
        jkw["g_bnbwd"] = tuple(_j(c) for c in consts)
        tkw["g_bnbwd"] = tuple(_t(c) for c in consts)
    else:
        jg, tg = _j(e), _t(e)
    if mask:
        vecs = [rng.rand(ci) + 0.5, rng.randn(ci) * 0.5, rng.randn(ci) * 0.3,
                rng.rand(ci) + 0.5]
        vecs = [v.astype(np.float32) for v in vecs]
        jkw["out_mask"] = (_j(x),) + tuple(_j(v) for v in vecs)
        tkw["out_mask"] = (_t(x),) + tuple(_t(v) for v in vecs)
    if s2 is not None:
        g2 = rng.randn(n, h // s2, h // s2, co2).astype(np.float32)
        w2 = (rng.randn(1, 1, ci, co2) / np.sqrt(ci)).astype(np.float32)
        jkw["extra"] = (_j(g2), _j(w2), s2)
        tkw["extra"] = (_t(g2), _t(w2), s2)
    want, wst = jfb.conv_dgrad(jg, _j(w), x.shape, **jkw)
    got, gst = tfb.conv_dgrad(tg, _t(w), x.shape, **tkw)
    want = np.asarray(want)
    _close(got.numpy(), want)
    if not mask:
        assert wst is None and gst is None
        return
    xhat = (x - tkw["out_mask"][3].numpy()) * tkw["out_mask"][4].numpy()
    scale = np.stack([np.abs(want).sum((0, 1, 2)),
                      np.abs(want * xhat).sum((0, 1, 2))])
    assert gst.shape == (2, ci)
    assert np.all(np.abs(gst.numpy() - np.asarray(wst)) <= 1e-4 * scale
                  + 1e-6)


@pytest.mark.parametrize("mask", [False, True], ids=["dx", "mask"])
@pytest.mark.parametrize("bnbwd", [False, True], ids=["g", "bnbwd"])
@pytest.mark.parametrize("k,stride,shape", _k_stride_cases(RAGGED_DGRAD))
def test_conv_dgrad_matches_pallas(k, stride, shape, bnbwd, mask):
    _dgrad_both(k, stride, bnbwd, mask, seed=k * 10 + stride,
                **_shape_kw(shape))


@pytest.mark.parametrize("s2,shape", [
    pytest.param(1, None, id="1"), pytest.param(2, None, id="2"),
    # the card tests' ragged extra terms: Ci 72 over a Co2 of 24, and a
    # Co2 of 136 (a partial 64-channel slice) at s2 = 2
    pytest.param(1, (2, 7, 72, 8, 24), id="1-2x7x72x8x24"),
    pytest.param(2, (1, 14, 8, 72, 136), id="2-1x14x8x72x136")])
@pytest.mark.parametrize("bnbwd", [False, True], ids=["g", "bnbwd"])
def test_conv_dgrad_extra_term_matches_pallas(bnbwd, s2, shape):
    """conv1's dgrad with the shortcut's gradient joining before the mask:
    only the pixels on the shortcut's stride-s2 grid take it."""
    kw = {}
    if shape is not None:
        kw = dict(zip(("n", "h", "ci", "co", "co2"), shape))
    _dgrad_both(1, 1, bnbwd, True, s2=s2, seed=40 + s2, **kw)


@pytest.mark.parametrize("case", [
    ("wgrad", 3, 1), ("wgrad", 3, 2), ("dgrad", 3, 1), ("dgrad", 3, 2),
    ("extra", 1, 1)])
def test_conv_grads_match_pallas_on_two_row_tiles(monkeypatch, case):
    """The JAX kernels on 2-row tiles, so that their halos cross tiles."""
    monkeypatch.setattr(jfb, "_tile_rows", lambda h, *_: 2 if h % 2 == 0
                        else 1)
    kind, k, stride = case
    if kind == "wgrad":
        _wgrad_both(k, stride, True, True, seed=50 + stride, h=16)
    elif kind == "dgrad":
        _dgrad_both(k, stride, True, True, seed=60 + stride, h=16)
    else:
        _dgrad_both(k, stride, True, True, s2=2, seed=70, h=16)


def test_conv_grads_refuse_mismatched_operands():
    x, w, _pro, e, y, _c = _conv_case(0, 2, 8, 8, 16, 3, 2)
    with pytest.raises(MXNetError, match="must be"):
        tfb.conv_wgrad(_t(x), _t(e[:, :3]), w.shape, stride=2)
    with pytest.raises(MXNetError, match="5 constants"):
        tfb.conv_dgrad((_t(e), _t(y)), _t(w), x.shape, stride=2,
                       g_bnbwd=(_t(e[0, 0, 0]),))
    with pytest.raises(ValueError, match="stride-2 requires even"):
        tfb.conv_dgrad(_t(e), _t(w), (2, 7, 7, 8), stride=2)


def test_cpu_calls_count_no_launches():
    x, w, _pro, e, y, consts = _conv_case(1, 2, 8, 8, 16, 3, 1)
    before = (tfb.conv_fwd.launches, tfb.conv_wgrad.launches,
              tfb.conv_dgrad.launches)
    tfb.conv_wgrad(_t(x), _t(e), w.shape)
    tfb.conv_dgrad(_t(e), _t(w), x.shape)
    args = [_t(a) for a in _unit_args(3, 2, False)]
    out, _ = tfb.bottleneck_train(*[a.requires_grad_() if a is not None
                                    else None for a in args], 2, EPS)
    out.sum().backward()
    assert (tfb.conv_fwd.launches, tfb.conv_wgrad.launches,
            tfb.conv_dgrad.launches) == before


@pytest.mark.parametrize("dtype,ci,co,co2,want", [
    ("bfloat16", 64, 64, None, (True, True)),
    ("bfloat16", 8, 72, 136, (True, True)),
    ("bfloat16", 64, 12, None, (False, False)),
    ("bfloat16", 20, 64, None, (False, False)),
    ("bfloat16", 64, 64, 12, (True, False)),
    ("float32", 64, 64, 24, (False, False))],
    ids=["bf16", "bf16-8-72-136", "bf16-co12", "bf16-ci20",
         "bf16-co2-12", "fp32"])
def test_conv_grads_route_by_shape(dtype, ci, co, co2, want):
    """B2 and B3 run on the tensor cores for bfloat16 whose channel counts
    (Ci, Co and the extra term's Co2) are multiples of 8, on the CUDA cores
    otherwise: decided from shapes and dtype alone (meta tensors)."""
    dt = getattr(torch, dtype)
    x = torch.empty(2, 8, 8, ci, dtype=dt, device="meta")
    w = torch.empty(3, 3, ci, co, dtype=dt, device="meta")
    extra = None
    if co2 is not None:
        extra = (torch.empty(2, 8, 8, co2, dtype=dt, device="meta"),
                 torch.empty(1, 1, ci, co2, dtype=dt, device="meta"), 1)
    assert (tfb._wgrad_tensor_cores(x, tuple(w.shape)),
            tfb._dgrad_tensor_cores(w, extra)) == want


def _grad_counts():
    return (tfb.conv_wgrad.launches, tfb.conv_wgrad.core_route_launches,
            tfb.conv_dgrad.launches, tfb.conv_dgrad.core_route_launches)


@pytest.mark.parametrize("co", [12, 16])
def test_cpu_calls_count_no_kernel_routes(co):
    """A CPU tensor runs the plain version: bf16 B2 and B3 calls add to
    neither the launch counts nor the CUDA-core route counts, whichever
    route their shape would take on the card."""
    x, w, (scale, bias), e, y, consts = _conv_case(2, 2, 8, 16, co, 3, 1)
    bf = torch.bfloat16
    xt, wt, et, yt = (_t(a).to(bf) for a in (x, w, e, y))
    pro = (_t(scale), _t(bias), True)
    cst = tuple(_t(c) for c in consts)
    vec = [_t(v) for v in (scale, bias, bias * 0.3, scale)]
    before = _grad_counts()
    dw = tfb.conv_wgrad(xt, (et, yt), w.shape, x_prologue=pro, g_bnbwd=cst)
    ex, st = tfb.conv_dgrad((et, yt), wt, x.shape, g_bnbwd=cst,
                            out_mask=(xt, *vec))
    assert dw.dtype == torch.float32 and ex.dtype == bf and st.shape == (2, 16)
    assert _grad_counts() == before


def test_meta_tensors_give_shapes_without_compute():
    x = torch.empty(2, 8, 8, 16, device="meta")
    g = torch.empty(2, 4, 4, 32, device="meta")
    w = torch.empty(3, 3, 16, 32, device="meta")
    dw = tfb.conv_wgrad(x, g, (3, 3, 16, 32), stride=2)
    assert dw.device.type == "meta" and dw.dtype == torch.float32
    assert tuple(dw.shape) == (3, 3, 16, 32)
    vec = torch.empty(16, device="meta")
    dx, st = tfb.conv_dgrad(g, w, (2, 8, 8, 16), stride=2,
                            out_mask=(x, vec, vec, vec, vec))
    assert tuple(dx.shape) == (2, 8, 8, 16) and tuple(st.shape) == (2, 16)


# ---------------------------------------------------------------------------
# the training unit
# ---------------------------------------------------------------------------
def _unit_args(seed, stride, dim_match, n=2, h=8, ci=8, c=8):
    co = ci if dim_match else 16
    rng = np.random.RandomState(seed)

    def f(*s):
        return rng.randn(*s).astype(np.float32)

    args = [f(n, h, h, ci), f(1, 1, ci, c) / np.sqrt(ci),
            f(3, 3, c, c) / np.sqrt(9 * c), f(1, 1, c, co) / np.sqrt(c),
            None if dim_match else f(1, 1, ci, co) / np.sqrt(ci),
            f(ci) * 0.2 + 1.0, f(ci) * 0.3, f(c) * 0.2 + 1.0, f(c) * 0.3,
            f(c) * 0.2 + 1.0, f(c) * 0.3]
    return [None if a is None else a.astype(np.float32) for a in args]


def _bn_relu(x, g, b):
    mean = x.mean(dim=(0, 1, 2))
    var = torch.clamp_min((x * x).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
    return torch.relu((x - mean) * torch.rsqrt(var + EPS) * g + b)


def _conv(x, w, stride):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def _unfused_unit(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3, stride):
    a1 = _bn_relu(data, g1, b1)
    y3 = _conv(_bn_relu(_conv(_bn_relu(_conv(a1, w1, 1), g2, b2), w2,
                              stride), g3, b3), w3, 1)
    return y3 + (data if wsc is None else _conv(a1, wsc, stride))


@pytest.mark.parametrize("stride,dim_match", [(1, True), (1, False),
                                              (2, False)])
def test_bottleneck_train_matches_jax_grad(stride, dim_match):
    args = _unit_args(stride * 2 + dim_match, stride, dim_match)
    idxs = [i for i, a in enumerate(args) if a is not None]
    cot = np.random.RandomState(9).randn(
        *(2, 8 // stride, 8 // stride, 8 if dim_match else 16)).astype(
            np.float32)
    jargs = [_j(a) for a in args]
    jout, jstats = jfb.bottleneck_train(*jargs, stride, EPS, True)
    jgrads = jax.grad(lambda *a: jnp.sum(
        jfb.bottleneck_train(*a, stride, EPS, True)[0] * cot),
        argnums=tuple(idxs))(*jargs)

    targs = [None if a is None else _t(a).requires_grad_() for a in args]
    tout, tstats = tfb.bottleneck_train(*targs, stride, EPS)
    assert all(not s.requires_grad for s in tstats)
    tgrads = torch.autograd.grad((tout * _t(cot)).sum(),
                                 [targs[i] for i in idxs])
    _close(tout.detach().numpy(), np.asarray(jout), what="out")
    for name, a, b in zip(("mean1", "var1", "mean2", "var2", "mean3",
                           "var3"), tstats, jstats):
        _close(a.numpy(), np.asarray(b), what=name)
    for i, a, b in zip(idxs, tgrads, jgrads):
        assert a.dtype == torch.float32
        _close(a.numpy(), np.asarray(b), what="grad of argument %d" % i)

    # the port's own unfused composition, to the JAX test's 5e-4 of the
    # largest |gradient| (the one-pass statistics and the mask's BN form
    # round differently from a two-pass BN)
    uargs = [None if a is None else _t(a).requires_grad_() for a in args]
    uout = _unfused_unit(*uargs, stride)
    ugrads = torch.autograd.grad((uout * _t(cot)).sum(),
                                 [uargs[i] for i in idxs])
    _close(tout.detach().numpy(), uout.detach().numpy(), rtol=0, atol=2e-4)
    for a, b in zip(tgrads, ugrads):
        _close(a.numpy(), b.numpy(), rtol=0, atol=5e-4)


def test_bottleneck_train_returns_gradients_in_the_input_dtypes():
    args = [None if a is None else _t(a).to(torch.bfloat16).requires_grad_()
            for a in _unit_args(7, 2, False)]
    out, stats = tfb.bottleneck_train(*args, 2, EPS)
    assert out.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in stats)
    grads = torch.autograd.grad(out.float().sum(),
                                [a for a in args if a is not None])
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               for g in grads)


# ---------------------------------------------------------------------------
# SoftmaxOutput's loss gradient and the training BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attrs", [
    {}, {"grad_scale": 0.5, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"smooth_alpha": 0.1, "normalization": "batch"},
    {"multi_output": True},
    {"multi_output": True, "use_ignore": True, "ignore_label": 1.0,
     "normalization": "valid", "smooth_alpha": 0.2}])
def test_softmax_output_gradient_matches_jax(attrs):
    rng = np.random.RandomState(3)
    if attrs.get("multi_output"):
        data = rng.randn(3, 4, 5).astype(np.float32)
        label = rng.randint(0, 4, (3, 5)).astype(np.float32)
    else:
        data = rng.randn(6, 7).astype(np.float32)
        label = rng.randint(0, 7, (6,)).astype(np.float32)
    cot = rng.randn(*data.shape).astype(np.float32)   # ignored by both
    jout, vjp = jax.vjp(lambda d, l: jnn.softmax_output(d, l, **attrs),
                        _j(data), _j(label))
    jgd, jgl = vjp(_j(cot))
    td, tl = _t(data).requires_grad_(), _t(label).requires_grad_()
    tout = tnn.softmax_output(td, tl, **attrs)
    tgd, tgl = torch.autograd.grad((tout * _t(cot)).sum(), (td, tl))
    _close(tout.detach().numpy(), np.asarray(jout))
    _close(tgd.numpy(), np.asarray(jgd))
    assert not tgl.any() and not np.asarray(jgl).any()


def test_training_batch_norm_data_gradient_matches_jax():
    """The f32 pivot (sample [0, :, 0, 0]) carries no gradient, as the
    JAX package stop-gradients it; a pivot in the graph adds two terms
    through the pivot sample that cancel only up to rounding, which made
    that sample the worst of all (1.8e-6 of the largest |gradient|, against
    8.8e-7 for the rest). Detached, it is no worse than the rest."""
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 6, 5, 5) * 0.2 + 3.0).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    mm, mv = np.zeros(6, np.float32), np.ones(6, np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    kw = dict(eps=2e-5, fix_gamma=False, __is_train__=True)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnn.batch_norm(
        v, _j(g), _j(b), _j(mm), _j(mv), **kw)[0] * cot))(_j(x)))
    tx = _t(x).requires_grad_()
    out = tnn.batch_norm(tx, _t(g), _t(b), _t(mm), _t(mv), **kw)[0]
    tg = torch.autograd.grad((out * _t(cot)).sum(), tx)[0].numpy()
    np.testing.assert_allclose(tg[0, :, 0, 0], jg[0, :, 0, 0], rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(tg, jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    gap = np.abs(tg - jg)
    pivot_gap = gap[0, :, 0, 0].max()
    gap[0, :, 0, 0] = 0.0
    assert pivot_gap <= gap.max()


# ---------------------------------------------------------------------------
# the training graph, TrainStep
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(BATCH_SEED)
    return {"data": rng.randn(*SHAPES["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, 5, SHAPES["softmax_label"])
            .astype(np.float32)}


def _jax_step(compute_dtype=None):
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        return jspmd.TrainStep(jresnet.resnet(fused=True, **TINY),
                               jspmd.functional_optimizer(**OPT),
                               compute_dtype=compute_dtype)


def _port_step(fused=True, **kw):
    return TrainStep(tresnet.resnet(fused=fused, **TINY), OPT, device="cpu",
                     **kw)


def test_init_params_are_bit_identical_to_jax():
    js, ts = _jax_step(), _port_step()
    jp, _jo, ja = js.init_params(SHAPES, initializer=mx.initializer.Xavier(),
                                 seed=0)
    tp, to, ta = ts.init_params(SHAPES, initializer=tinit.Xavier(), seed=0)
    assert list(tp) == list(jp) and list(ta) == list(ja)
    for d_t, d_j in ((tp, jp), (ta, ja)):
        for k in d_j:
            assert d_t[k].dtype == torch.float32
            assert np.array_equal(d_t[k].numpy(), np.asarray(d_j[k])), k
    assert set(to) == set(tp) and not any(v.any() for v in to.values())


def test_initializers_fill_as_jax_does(monkeypatch):
    shape = (6, 4, 3, 3)
    for kind, args in (("xavier", dict(rnd_type="gaussian", factor_type="in",
                                       magnitude=2)),
                       ("uniform", dict(scale=0.3)), ("normal", {}),
                       ("constant", dict(value=0.25)), ("zero", {}),
                       ("one", {})):
        with tinit.seeded(11):
            t = torch.empty(shape)
            tinit.create(kind, **args)("w_weight", t)
        monkeypatch.setattr(mx.random, "_INIT_RNG",
                            np.random.RandomState(11))
        j = mx.nd.zeros(shape)
        mx.initializer.create(kind, **args)("w_weight", j)
        assert np.array_equal(t.numpy(), j.asnumpy()), kind
    t = torch.empty(3)
    tinit.Xavier()("bn_moving_var", t)
    assert t.tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("nope")


def test_graph_closure_outputs_and_aux_updates_match_jax(batch):
    sym_t = tresnet.resnet(fused=True, **TINY)
    sym_j = jresnet.resnet(fused=True, **TINY)
    tp, _to, ta = _port_step().init_params(SHAPES,
                                           initializer=tinit.Xavier())
    values = {k: v.numpy() for d in (tp, ta) for k, v in d.items()}
    values.update(batch)
    jouts, jaux = jax_graph_closure(sym_j, True)(
        {k: _j(v) for k, v in values.items()}, jax.random.PRNGKey(0))
    touts, taux = _graph_closure(sym_t, True)(
        {k: _t(v) for k, v in values.items()})
    assert len(touts) == len(jouts) == 1
    _close(touts[0].numpy(), np.asarray(jouts[0]))
    assert set(taux) == set(jaux) == set(sym_t.list_auxiliary_states())
    for k, v in taux.items():
        assert not v.requires_grad
        _close(v.numpy(), np.asarray(jaux[k]), what=k)
    # inference mode: no aux updates
    assert _graph_closure(sym_t, False)(
        {k: _t(v) for k, v in values.items()})[1] == {}


def _run_steps(step, carry, batch, n=3):
    losses = []
    for _ in range(n):
        carry, loss = step(carry, batch)
        losses.append(float(loss))
    return carry, losses


@pytest.fixture(scope="module")
def jax_runs(batch):
    """Three steps of the JAX TrainStep (mesh=None) in fp32 and bf16 from
    Xavier params of seed 0: {dtype: (params, aux, losses)}."""
    runs = {}
    for cd in (None, "bfloat16"):
        js = _jax_step(cd)
        with pytest.MonkeyPatch.context() as mp:
            if not hasattr(pltpu, "TPUCompilerParams"):
                mp.setattr(pltpu, "TPUCompilerParams",
                           pltpu.CompilerParams, raising=False)
            carry = js.place(*js.init_params(
                SHAPES, initializer=mx.initializer.Xavier()))
            losses = []
            for _ in range(3):
                carry, loss = js(carry, {k: _j(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0))
                losses.append(float(loss))
        runs[cd] = ({k: np.asarray(v) for k, v in carry[0].items()},
                    {k: np.asarray(v) for k, v in carry[2].items()}, losses)
    return runs


def test_three_fp32_steps_match_jax_train_step(jax_runs, batch):
    ts = _port_step()
    p0, o0, a0 = ts.init_params(SHAPES, initializer=tinit.Xavier())
    (params, _opt, aux, step_no), losses = _run_steps(
        ts, ts.place(p0, o0, a0), batch)
    jp, ja, jl = jax_runs[None]
    assert step_no == 3
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    for k in jp:
        assert params[k].dtype == torch.float32
        _close(params[k].numpy(), jp[k], what=k)
    for k in ja:
        _close(aux[k].numpy(), ja[k], what=k)


def test_three_bf16_steps_match_jax_train_step(jax_runs, batch):
    """bf16 compute rounds in other places in the two packages (the stem's
    library convolution, the BN folding, the softmax), and in this tiny
    net (4 channels a BN in stage 1) a gradient is the small difference of
    large terms: against the same run in fp32 each package's bf16
    gradients are 10-30% off in relative L2, and the two packages' bf16
    runs 8-20% off each other. So: the losses within 3% of JAX's, the
    whole three-step update (all params, as one vector) within 30% in
    relative L2 at a cosine >= 0.95, and every aux within 10% of its
    largest |value|."""
    ts = _port_step(compute_dtype="bfloat16")
    p0, o0, a0 = ts.init_params(SHAPES, initializer=tinit.Xavier())
    start = {k: v.clone() for k, v in p0.items()}
    (params, _opt, aux, _n), losses = _run_steps(
        ts, ts.place(p0, o0, a0), batch)
    jp, ja, jl = jax_runs["bfloat16"]
    np.testing.assert_allclose(losses, jl, rtol=3e-2)
    assert all(v.dtype == torch.float32 for v in params.values())
    ut = np.concatenate([(params[k] - start[k]).numpy().ravel() for k in jp])
    uj = np.concatenate([(jp[k] - start[k].numpy()).ravel() for k in jp])
    assert np.linalg.norm(ut - uj) <= 0.3 * np.linalg.norm(uj)
    assert ut @ uj >= 0.95 * np.linalg.norm(ut) * np.linalg.norm(uj)
    for k in ja:
        _close(aux[k].numpy(), ja[k], rtol=0, atol=0.1, what=k)


def _gradients(fused, params, aux, batch):
    """One step's parameter gradients of the port's graph (summed over the
    batch, before the division by its size)."""
    return _port_step(fused).value_and_grad(params, aux, batch)[1]


def test_fused_gradients_match_unfused_in_the_port(batch):
    p, _o, a = _port_step().init_params(SHAPES, initializer=tinit.Xavier())
    gf = _gradients(True, p, a, batch)
    gu = _gradients(False, p, a, batch)
    assert set(gf) == set(gu)
    for k in gu:
        # tests/test_fused_resnet.py's bar: 2e-3 of the largest |gradient|
        _close(gf[k].numpy(), gu[k].numpy(), rtol=0, atol=2e-3, what=k)


# ---------------------------------------------------------------------------
# what is not ported, devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,knob,name", [
    (dict(zero_wire="2bit"), ("MXNET_TPU_ZERO_WIRE", "2bit"), "zero_wire")])
def test_unported_train_step_options_raise_by_name(monkeypatch, kw, knob,
                                                   name):
    sym = tresnet.resnet(fused=True, **TINY)
    with pytest.raises(MXNetError, match="%s.*not ported" % name):
        TrainStep(sym, OPT, device="cpu", **kw)
    if knob is not None:
        monkeypatch.setenv(*knob)
        with pytest.raises(MXNetError, match="%s.*not ported" % name):
            TrainStep(sym, OPT, device="cpu")


def test_malformed_knob_raises_with_its_name(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SENTINEL", "sometimes")
    with pytest.raises(MXNetError, match="MXNET_TPU_SENTINEL"):
        TrainStep(tresnet.resnet(fused=True, **TINY), OPT, device="cpu")


def test_train_step_defaults_to_cuda():
    sym = tresnet.resnet(fused=True, **TINY)
    if torch.cuda.is_available():
        assert TrainStep(sym, OPT).device.type == "cuda"
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            TrainStep(sym, OPT)


def test_train_step_on_cpu_counts_no_launches(batch):
    before = (tfb.conv_fwd.launches, tfb.conv_wgrad.launches,
              tfb.conv_dgrad.launches)
    ts = _port_step()
    carry = ts.place(*ts.init_params(SHAPES, initializer=tinit.Xavier()))
    carry, loss = ts(carry, batch)
    assert np.isfinite(float(loss)) and carry[3] == 1
    assert (tfb.conv_fwd.launches, tfb.conv_wgrad.launches,
            tfb.conv_dgrad.launches) == before
