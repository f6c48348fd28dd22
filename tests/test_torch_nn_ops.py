"""The nn ops of the port's 7a slice against the JAX package's, on the CPU.

Each case sends the same numpy-seeded inputs through the JAX op (its
registry function; a random op gets a PRNG key) and the port's (a
``torch.Generator``), and holds the outputs together. Then it holds the
gradient of every float input, for one seeded cotangent a visible output,
against ``jax.vjp`` through the JAX op's own backward (the loss heads'
``custom_vjp``s included). The cases are ``tests/test_op_sweep.py``'s specs
for these names and ``tests/test_op_grids.py``'s deconvolution grid, with
the modes, attributes and edge cases each op has beside them (LRN at an
even ``nsize``, deconvolution with groups, dilation and ``adj`` above the
pad, bilinear upsampling of odd sizes, ``Pooling(pooling_convention=
"full")``). fp32 on both sides: rtol 1e-4, atol 1e-5.

The random draws (Dropout, LeakyReLU's rrelu) are not threefry's, so they
are held by distribution and by self-consistency: inference equals JAX
exactly; the keep rate is within 5 sigma of ``1 - p``; kept elements are
scaled by exactly ``1 / (1 - p)``; the gradient is the forward's mask
times the cotangent; two runs from one seed are bit for bit equal, through
the executor (a backward that reruns the forward replays its draws, remat
recomputes them) and the imperative ``nd`` call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.executor import _graph_closure
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def U(shape, lo=0.5, hi=1.5, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def N(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def away_from_zero(shape, seed=0):
    """Signed values at least 0.2 from 0 (the kink of the leaky family)."""
    x = N(shape, seed)
    return np.where(x >= 0, x + 0.2, x - 0.2).astype(np.float32)


_IMG = U((2, 3, 6, 6), seed=3)
_D23 = N((2, 3), seed=1)
_LBL = np.array([2, 0], np.float32)

# (id, op name, inputs, attrs, indices of the inputs to differentiate)
CASES = [
    ("leaky", "LeakyReLU", [away_from_zero((2, 3, 4), 1)],
     {"act_type": "leaky", "slope": 0.1}, (0,)),
    ("prelu", "LeakyReLU", [away_from_zero((2, 3, 4, 4), 2),
                            U((3,), 0.1, 0.4, seed=3)],
     {"act_type": "prelu"}, (0, 1)),
    ("elu", "LeakyReLU", [away_from_zero((2, 3, 4), 4)],
     {"act_type": "elu", "slope": 0.7}, (0,)),
    ("selu", "LeakyReLU", [away_from_zero((2, 3, 4), 5)],
     {"act_type": "selu"}, (0,)),
    ("gelu", "LeakyReLU", [N((2, 3, 4), 6)], {"act_type": "gelu"}, (0,)),
    ("rrelu-infer", "LeakyReLU", [away_from_zero((2, 3, 4), 7)],
     {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3}, (0,)),
    ("instance-norm", "InstanceNorm", [_IMG, U((3,), seed=77),
                                       N((3,), seed=78)], {}, (0, 1, 2)),
    ("instance-norm-eps", "InstanceNorm", [N((2, 4, 3, 5), 9),
                                           U((4,), seed=10),
                                           N((4,), seed=11)],
     {"eps": 1e-5}, (0, 1, 2)),
    ("l2-instance", "L2Normalization", [N((2, 3, 4), 12)], {}, (0,)),
    ("l2-channel", "L2Normalization", [N((2, 3, 4, 4), 13)],
     {"mode": "channel"}, (0,)),
    ("l2-spatial", "L2Normalization", [N((2, 3, 4, 4), 14)],
     {"mode": "spatial"}, (0,)),
    ("l2-sweep", "L2Normalization", [_D23], {}, (0,)),
    ("lrn-3", "LRN", [_IMG], {"nsize": 3}, (0,)),
    ("lrn-4-even", "LRN", [U((2, 6, 3, 3), seed=15)],
     {"nsize": 4, "alpha": 1e-2, "beta": 0.5, "knorm": 1.0}, (0,)),
    ("lrn-5", "LRN", [U((2, 7, 3, 3), seed=16)],
     {"nsize": 5, "alpha": 1e-3}, (0,)),
    ("softmax-act-instance", "SoftmaxActivation", [N((2, 3, 2, 2), 17)],
     {}, (0,)),
    ("softmax-act-channel", "SoftmaxActivation", [N((2, 3, 2, 2), 18)],
     {"mode": "channel"}, (0,)),
    ("block-grad", "BlockGrad", [_D23], {}, (0,)),
    ("identity-kl", "IdentityAttachKLSparseReg", [U((2, 3), seed=2)], {},
     (0,)),
    ("dropout-p0", "Dropout", [U((2, 3), seed=2)],
     {"p": 0.0, "__is_train__": True}, (0,)),
    ("dropout-infer", "Dropout", [U((2, 3, 4), seed=19)], {"p": 0.5},
     (0,)),
    ("make-loss", "make_loss", [U((2, 3), seed=5)], {}, (0,)),
    ("make-loss-batch", "make_loss", [N((4, 3), 20)],
     {"grad_scale": 2.0, "normalization": "batch"}, (0,)),
    ("make-loss-valid", "make_loss", [N((4, 3), 21)],
     {"grad_scale": 0.5, "normalization": "valid", "valid_thresh": 0.1},
     (0,)),
    ("linear-regression", "LinearRegressionOutput",
     [_D23, N((2, 3), seed=99)], {"grad_scale": 1.5}, (0,)),
    ("mae-regression", "MAERegressionOutput", [_D23, N((2, 3), seed=100)],
     {}, (0,)),
    ("logistic-regression", "LogisticRegressionOutput",
     [_D23, U((2, 3), 0.0, 1.0, seed=101)], {"grad_scale": 0.5}, (0,)),
    ("svm-l2", "SVMOutput", [N((4, 5), 24), np.array([0, 3, 1, 4],
                                                    np.float32)],
     {"margin": 1.0, "regularization_coefficient": 0.5}, (0,)),
    ("svm-l1", "SVMOutput", [N((4, 5), 25), np.array([2, 2, 0, 1],
                                                    np.float32)],
     {"use_linear": True, "margin": 0.5}, (0,)),
    ("softmax-ce", "softmax_cross_entropy", [_D23, _LBL], {}, (0,)),
    ("deconv-sweep", "Deconvolution",
     [U((2, 3, 4, 4), seed=70), N((3, 4, 3, 3), seed=71, scale=0.3),
      N((4,), seed=72)], {"kernel": (3, 3), "num_filter": 4,
                          "no_bias": False}, (0, 1, 2)),
    ("deconv-groups", "Deconvolution",
     [N((2, 4, 3, 3), 26), N((4, 3, 2, 2), 27, 0.3)],
     {"kernel": (2, 2), "num_filter": 6, "num_group": 2, "stride": (2, 2)},
     (0, 1)),
    ("deconv-dilate", "Deconvolution",
     [N((1, 2, 4, 5), 28), N((2, 3, 3, 3), 29, 0.3)],
     {"kernel": (3, 3), "num_filter": 3, "dilate": (2, 1), "pad": (1, 2)},
     (0, 1)),
    ("deconv-adj-above-pad", "Deconvolution",
     [N((1, 2, 3, 3), 30), N((2, 2, 3, 3), 31, 0.3)],
     {"kernel": (3, 3), "num_filter": 2, "stride": (3, 3), "adj": (2, 1),
      "pad": (0, 1)}, (0, 1)),
    ("deconv-1d", "Deconvolution", [N((2, 3, 5), 32), N((3, 2, 3), 33)],
     {"kernel": (3,), "num_filter": 2, "stride": (2,), "pad": (1,)},
     (0, 1)),
    ("upsample-nearest", "UpSampling", [U((1, 2, 3, 3), seed=80)],
     {"scale": 2, "sample_type": "nearest", "num_args": 1}, (0,)),
    ("upsample-nearest-concat", "UpSampling",
     [N((1, 2, 4, 4), 34), N((1, 3, 2, 2), 35)],
     {"scale": 2, "sample_type": "nearest", "num_args": 2}, (0, 1)),
    ("upsample-nearest-sum", "UpSampling",
     [N((1, 2, 4, 4), 36), N((1, 2, 2, 2), 37)],
     {"scale": 2, "sample_type": "nearest", "num_args": 2,
      "multi_input_mode": "sum"}, (0, 1)),
    ("upsample-bilinear", "UpSampling",
     [N((1, 2, 3, 3), 38), N((2, 1, 4, 4), 39)],
     {"scale": 2, "sample_type": "bilinear", "num_args": 2}, (0, 1)),
    ("upsample-bilinear-odd", "UpSampling",
     [N((2, 3, 5, 4), 40), N((3, 1, 6, 6), 41)],
     {"scale": 3, "sample_type": "bilinear", "num_args": 2}, (0, 1)),
    ("crop-hw", "Crop", [_IMG], {"h_w": (4, 4), "num_args": 1}, (0,)),
    ("crop-offset", "Crop", [N((2, 3, 7, 6), 42)],
     {"h_w": (3, 4), "offset": (2, 1), "num_args": 1}, (0,)),
    ("crop-center", "Crop", [N((2, 3, 7, 6), 43)],
     {"h_w": (4, 3), "center_crop": True, "num_args": 1}, (0,)),
    ("crop-like", "Crop", [N((2, 3, 7, 6), 44), N((2, 5, 3, 2), 45)],
     {"num_args": 2, "offset": (1, 3)}, (0,)),
    ("grid-affine", "GridGenerator", [N((2, 6), seed=81)],
     {"transform_type": "affine", "target_shape": (4, 5)}, (0,)),
    ("grid-warp", "GridGenerator", [N((2, 2, 4, 5), 46)],
     {"transform_type": "warp"}, (0,)),
    ("bilinear-sampler", "BilinearSampler",
     [U((1, 2, 4, 4), seed=82), np.clip(N((1, 2, 3, 3), seed=83), -0.7,
                                        0.7)], {}, (0, 1)),
    ("bilinear-sampler-outside", "BilinearSampler",
     [N((2, 3, 5, 4), 47), N((2, 2, 3, 4), 48, 0.9)], {}, (0, 1)),
    ("spatial-transformer", "SpatialTransformer",
     [U((1, 2, 4, 4), seed=84), N((1, 6), seed=85, scale=0.1)],
     {"transform_type": "affine", "sampler_type": "bilinear",
      "target_shape": (3, 3)}, (0, 1)),
    ("correlation", "Correlation",
     [U((1, 2, 5, 5), seed=94), U((1, 2, 5, 5), seed=95)],
     {"kernel_size": 1, "max_displacement": 1, "stride1": 1,
      "stride2": 1}, (0, 1)),
    ("correlation-pad-abs", "Correlation",
     [N((2, 3, 4, 5), 49), N((2, 3, 4, 5), 50)],
     {"max_displacement": 2, "stride2": 2, "pad_size": 1,
      "is_multiply": False}, (0, 1)),
]

# tests/test_op_grids.py's DECONV_GRID: (in_shape, nf, kernel, stride, pad,
# adj)
DECONV_GRID = [
    ((2, 4, 5, 5), 3, (3, 3), (1, 1), (0, 0), (0, 0)),
    ((2, 4, 5, 5), 3, (3, 3), (2, 2), (1, 1), (0, 0)),
    ((2, 4, 5, 5), 3, (3, 3), (2, 2), (1, 1), (1, 1)),
    ((2, 4, 6, 4), 3, (2, 3), (2, 1), (0, 1), (1, 0)),
    ((1, 2, 1, 1), 2, (4, 4), (4, 4), (0, 0), (0, 0)),
]
for _i, (_shape, _nf, _k, _s, _p, _a) in enumerate(DECONV_GRID):
    CASES.append(("deconv-grid%d" % _i, "Deconvolution",
                  [N(_shape, 60 + _i), N((_shape[1], _nf) + _k, 70 + _i)],
                  {"kernel": _k, "num_filter": _nf, "stride": _s,
                   "pad": _p, "adj": _a}, (0, 1)))

# Pooling(pooling_convention="full"): ceil-mode windows
FULL_POOLS = [
    ((2, 3, 7, 7), (3, 3), (2, 2), (0, 0)),
    ((2, 3, 8, 8), (3, 3), (2, 2), (1, 1)),
    ((2, 3, 5, 6), (2, 2), (2, 2), (0, 0)),
    ((1, 2, 9, 7), (3, 2), (2, 3), (1, 0)),
    ((1, 2, 6, 6), (3, 3), (3, 3), (1, 1)),
]
for _i, (_shape, _k, _s, _p) in enumerate(FULL_POOLS):
    for _pool in ("max", "avg", "sum"):
        CASES.append(("pool-full%d-%s" % (_i, _pool), "Pooling",
                      [N(_shape, 80 + _i)],
                      {"kernel": _k, "stride": _s, "pad": _p,
                       "pool_type": _pool, "pooling_convention": "full"},
                      (0,)))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _jax_call(op, arrays, attrs):
    if op.needs_rng:
        return op.fn(jax.random.PRNGKey(0), *arrays, **attrs)
    return op.fn(*arrays, **attrs)


def _torch_call(op, tensors, attrs):
    if op.needs_rng:
        gen = torch.Generator()
        gen.manual_seed(0)
        return op.fn(gen, *tensors, **attrs)
    return op.fn(*tensors, **attrs)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_gradient_match_jax(case):
    _id, name, inputs, attrs, diff = case
    jop, top = jreg.get(name), treg.get(name)
    n_vis = jop.n_visible_outputs(attrs)
    assert n_vis == top.n_visible_outputs(attrs)

    jouts = _outputs(_jax_call(jop, [jnp.asarray(x) for x in inputs],
                               attrs))
    tens = [torch.tensor(x, requires_grad=i in diff)
            for i, x in enumerate(inputs)]
    touts = _outputs(_torch_call(top, tens, attrs))
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        _close(t.detach().numpy(), j, "%s output %d" % (name, k))

    # gradients of <cotangent, visible outputs>
    rng = np.random.RandomState(1234)
    cots = [np.asarray(rng.randn(*np.shape(j)), np.float32)
            for j in jouts[:n_vis]]

    def jfn(*diffed):
        full = [jnp.asarray(x) for x in inputs]
        for i, d in zip(diff, diffed):
            full[i] = d
        return _outputs(_jax_call(jop, full, attrs))[:n_vis]

    _, vjp = jax.vjp(jfn, *[jnp.asarray(inputs[i]) for i in diff])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    heads = [t for t in touts[:n_vis] if t.requires_grad]
    if heads:
        tgrads = torch.autograd.grad(
            heads, [tens[i] for i in diff],
            [torch.from_numpy(c) for t, c in zip(touts[:n_vis], cots)
             if t.requires_grad], allow_unused=True)
    else:
        tgrads = [None] * len(diff)
    for i, tg, jg in zip(diff, tgrads, jgrads):
        tg = np.zeros(inputs[i].shape, np.float32) if tg is None \
            else tg.numpy()
        _close(tg, jg, "%s gradient of input %d" % (name, i))


def test_bilinear_upsampling_weight_gets_a_zero_gradient():
    x = torch.tensor(N((1, 2, 3, 3), 51), requires_grad=True)
    w = torch.tensor(N((2, 1, 4, 4), 52), requires_grad=True)
    ex = mx.sym.UpSampling(mx.sym.var("x"), mx.sym.var("w"), scale=2,
                           sample_type="bilinear", num_args=2).bind(
        mx.cpu(), {"x": mx.nd.array(x.detach().numpy()),
                   "w": mx.nd.array(w.detach().numpy())},
        args_grad={"x": mx.nd.zeros(x.shape), "w": mx.nd.ones(w.shape)})
    ex.forward(is_train=True)
    ex.backward(mx.nd.ones(ex.outputs[0].shape))
    assert not ex.grad_dict["w"].asnumpy().any()
    assert ex.grad_dict["x"].asnumpy().any()


def test_unknown_modes_raise_by_name():
    x = torch.ones(2, 3, 4, 4)
    with pytest.raises(mx.MXNetError, match="L2Normalization"):
        treg.get("L2Normalization").fn(x, mode="row")
    with pytest.raises(mx.MXNetError, match="UpSampling"):
        treg.get("UpSampling").fn(x, sample_type="cubic")
    with pytest.raises(mx.MXNetError, match="pooling_convention"):
        treg.get("Pooling").fn(x, kernel=(2, 2), pooling_convention="same")


# ---------------------------------------------------------------------------
# the random ops: by distribution and by self-consistency
# ---------------------------------------------------------------------------
def _dropout(seed, x, **attrs):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return treg.get("Dropout").fn(gen, x, **attrs)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keep_rate_and_scale(p):
    x = torch.ones(200, 500)
    out, mask = _dropout(3, x, p=p, __is_train__=True)
    keep = 1.0 - p
    rate = float((mask != 0).float().mean())
    sigma = np.sqrt(keep * (1 - keep) / mask.numel())
    assert abs(rate - keep) < 5 * sigma, (rate, keep, sigma)
    kept = mask[mask != 0].numpy()
    assert (kept == np.float32(1) / np.float32(keep)).all()
    assert torch.equal(out, x * mask)


def test_dropout_gradient_is_the_forwards_mask():
    x = torch.tensor(N((30, 40), 53), requires_grad=True)
    out, mask = _dropout(5, x, p=0.4, __is_train__=True)
    g = torch.tensor(N((30, 40), 54))
    (dx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(dx, mask * g)


def test_dropout_axes_share_the_mask_and_always_draws_in_inference():
    x = torch.ones(4, 6, 5, 5)
    out, mask = _dropout(7, x, p=0.5, axes=(2, 3), mode="always")
    assert not torch.equal(out, x)
    assert torch.equal(mask, mask[:, :, :1, :1].expand_as(mask))
    assert (mask[:, :, 0, 0] == 0).any() and (mask[:, :, 0, 0] != 0).any()


def test_dropout_inference_is_the_identity_as_in_jax():
    x = U((3, 4, 5), seed=55)
    want = jreg.get("Dropout").fn(jax.random.PRNGKey(1), jnp.asarray(x),
                                  p=0.5)
    got = _dropout(1, torch.from_numpy(x), p=0.5)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_rrelu_draws_slopes_in_bounds_and_its_gradient():
    x = torch.tensor(-np.abs(N((100, 100), 56)) - 0.1, requires_grad=True)
    gen = torch.Generator()
    gen.manual_seed(2)
    out = treg.get("LeakyReLU").fn(gen, x, act_type="rrelu",
                                   lower_bound=0.1, upper_bound=0.3,
                                   __is_train__=True)
    slope = (out / x).detach()
    assert float(slope.min()) >= 0.1 and float(slope.max()) < 0.3
    mean, n = float(slope.mean()), slope.numel()
    assert abs(mean - 0.2) < 5 * (0.2 / np.sqrt(12)) / np.sqrt(n)
    (dx,) = torch.autograd.grad(out.sum(), x)
    np.testing.assert_allclose(dx.numpy(), slope.numpy(), rtol=1e-6)


def _dropout_graph():
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=16, name="fc")
    d1 = mx.sym.Dropout(fc, p=0.5, name="drop1")
    # LeakyReLU makes its gamma variable whatever act_type (as the
    # reference's does); rrelu leaves it unused
    act = mx.sym.LeakyReLU(d1, mx.sym.var("rrelu_gamma", shape=(1,)),
                           act_type="rrelu", name="rrelu")
    d2 = mx.sym.Dropout(act, p=0.3, name="drop2")
    return mx.sym.MakeLoss(mx.sym.sum(d2 * d2), name="loss")


def _bound(sym):
    rng = np.random.RandomState(8)
    ex = sym.simple_bind(mx.cpu(), data=(8, 12))
    ex.arg_dict["data"][:] = rng.randn(8, 12).astype(np.float32)
    ex.arg_dict["fc_weight"][:] = rng.randn(16, 12).astype(np.float32)
    return ex


def test_executors_seeded_alike_draw_alike():
    sym = _dropout_graph()
    runs = []
    for _ in range(2):
        ex = _bound(sym)
        mx.random.seed(11)
        ex.forward_backward()
        first = ex.grad_dict["fc_weight"].asnumpy()
        ex.forward_backward()
        runs.append((first, ex.grad_dict["fc_weight"].asnumpy(),
                     ex.outputs[0].asnumpy()))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
    assert np.array_equal(runs[0][2], runs[1][2])
    # two steps draw two different masks
    assert not np.array_equal(runs[0][0], runs[0][1])


def test_backward_uses_the_forwards_masks():
    sym = _dropout_graph()
    ex = _bound(sym)
    mx.random.seed(12)
    ex.forward(is_train=True)
    loss = ex.outputs[0].asnumpy()
    ex.backward()
    g1 = ex.grad_dict["fc_weight"].asnumpy()
    # a backward with no graph kept reruns the forward from its step seed
    ex.backward()
    assert np.array_equal(g1, ex.grad_dict["fc_weight"].asnumpy())
    assert np.array_equal(loss, ex.outputs[0].asnumpy())
    # the gradient is d(sum(out**2)) through the kept masks: compare with
    # the graph evaluated by hand from the same step seed
    seed = ex._last_seed
    values = {n: a.tensor.clone() for n, a in ex.arg_dict.items()}
    values["fc_weight"].requires_grad_()
    outs, _ = _graph_closure(sym, True)(values, seed)
    (gw,) = torch.autograd.grad(outs[0].sum(), values["fc_weight"])
    assert np.array_equal(gw.numpy(), g1)


def test_remat_recomputes_the_same_draws():
    sym = _dropout_graph()
    ex = _bound(sym)
    grads = []
    for remat in (None, set()):
        values = {n: a.tensor.clone() for n, a in ex.arg_dict.items()}
        values["fc_weight"].requires_grad_()
        outs, _ = _graph_closure(sym, True, remat_names=remat)(values, 99)
        grads.append(torch.autograd.grad(outs[0].sum(),
                                         values["fc_weight"])[0])
    assert torch.equal(grads[0], grads[1])


def test_imperative_dropout_repeats_from_a_seed_and_records():
    x = mx.nd.array(U((20, 30), seed=57))
    got = []
    for _ in range(2):
        mx.random.seed(21)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=0.5)
        y.backward(mx.nd.ones(y.shape))
        got.append((y.asnumpy(), x.grad.asnumpy()))
    assert np.array_equal(got[0][0], got[1][0])
    assert np.array_equal(got[0][1], got[1][1])
    # the gradient is the mask the forward drew
    mask = got[0][0] / x.asnumpy()
    np.testing.assert_allclose(got[0][1], mask, rtol=1e-6)
    with mx.autograd.predict_mode():
        assert np.array_equal(mx.nd.Dropout(x, p=0.5).asnumpy(),
                              x.asnumpy())


def test_serving_draws_from_the_inference_seed_through_eval_node():
    """``AOTPredictor`` evaluates a ``Dropout(mode="always")`` through
    ``eval_node`` from ``executor.INFERENCE_SEED``: every request draws the
    same mask, the graph closure's from that seed."""
    from mxnet_tpu_torch.executor import INFERENCE_SEED
    from mxnet_tpu_torch.serving import AOTPredictor

    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=32, name="fc")
    sym = mx.sym.Dropout(fc, p=0.5, mode="always", name="drop")
    rng = np.random.RandomState(13)
    params = {"fc_weight": rng.randn(32, 6).astype(np.float32),
              "fc_bias": rng.randn(32).astype(np.float32)}
    x = rng.randn(4, 6).astype(np.float32)
    pred = AOTPredictor(sym, params, data_shapes={"data": (4, 6)},
                        ladder=(4,), device="cpu")
    first, again = pred.predict({"data": x}), pred.predict({"data": x})
    values = {k: torch.from_numpy(v) for k, v in params.items()}
    values["data"] = torch.from_numpy(x)
    want = _graph_closure(sym, False)(values, INFERENCE_SEED)[0][0]
    assert np.array_equal(first[0], again[0])
    assert np.array_equal(first[0], want.numpy())
    assert (first[0] == 0).any()
