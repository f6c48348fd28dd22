"""``mx.operator`` and the ``Custom`` op of the PyTorch port against the
JAX package's, on the CPU.

- The six Custom scenarios of ``tests/test_parity_modules.py`` (imperative
  with its gradient, symbolic in a graph, tensor kwargs bound by name, the
  real ``is_train`` flag, an unknown type, the legacy ops), each run in
  both packages on the same inputs.
- ``nd.Custom`` under ``autograd.record`` with two inputs, and under
  ``MXNET_BACKWARD_DO_MIRROR=1`` (the body's forward reruns in the
  backward, as ``jax.checkpoint`` reruns the JAX callback).
- The numpy softmax head of ``examples/numpy-ops/numpy_softmax.py`` as the
  loss head of that example's MLP and of the tiny fused ResNet of
  ``tests/test_torch_module.py``, each trained 3 batches by
  ``Module.fit`` in both packages from the same weights (the ResNet's
  carried by ``models/resnet.py`` ``params_from_jax``): the loss of every
  batch and every parameter and moving statistic after the fit.
- A prop with auxiliary states raises in both; shape and type inference
  answer from the prop and never call the body.

The fused ResNet's JAX side runs its Pallas kernels in interpret mode
with the ``TPUCompilerParams`` alias of ROADMAP.md Queue C, set by
``monkeypatch``. Tolerance: rtol 1e-4, atol 1e-5 (of the largest |value|
for whole tensors).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet

RTOL, ATOL = 1e-4, 1e-5
PKG = {"jax": jmx, "port": tmx}
CALLS = {"jax": 0, "port": 0}   # body forward calls of the counted op


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=ATOL * max(float(np.abs(want).max()), 1.0), err_msg=what)


def _register(key, mx):
    """The test's custom ops, registered in one package under names of
    their own (suffix ``_tc``)."""
    nd = mx.nd

    @mx.operator.register("sqr_tc")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            scale = self.scale

            class Sqr(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], nd.array(scale * x * x))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    x = in_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                nd.array(2 * scale * x * g))

            return Sqr()

    @mx.operator.register("sub2_tc")
    class Sub2Prop(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["lhs", "rhs"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]]  # the 2-tuple form

        def create_operator(self, ctx, shapes, dtypes):
            class Sub2(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] - in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])
                    self.assign(in_grad[1], req[1], -out_grad[0])

            return Sub2()

    @mx.operator.register("trainflag_tc")
    class TFProp(mx.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            class TF(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    scale = 2.0 if is_train else 1.0
                    self.assign(out_data[0], req[0], in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])

            return TF()

    @mx.operator.register("counted_tanh_tc")
    class CountedProp(mx.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Counted(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    CALLS[key] += 1
                    y = np.tanh(in_data[0].asnumpy())
                    self.assign(out_data[0], req[0], nd.array(y))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y = out_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                nd.array(g * (1 - y * y)))

            return Counted()

    @mx.operator.register("with_aux_tc")
    class AuxProp(mx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["moving"]

    @mx.operator.register("numpy_softmax_tc")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        """``examples/numpy-ops/numpy_softmax.py``'s loss head."""

        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            return [data_shape, label_shape], [data_shape], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class NumpySoftmax(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    y = np.exp(x - x.max(axis=1, keepdims=True))
                    y /= y.sum(axis=1, keepdims=True)
                    self.assign(out_data[0], req[0], nd.array(y))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    lbl = in_data[1].asnumpy().astype(np.int32)
                    y = out_data[0].asnumpy()
                    dx = y.copy()
                    dx[np.arange(lbl.shape[0]), lbl] -= 1.0
                    self.assign(in_grad[0], req[0], nd.array(dx))
                    self.assign(in_grad[1], req[1],
                                nd.zeros(in_data[1].shape))

            return NumpySoftmax()


for _key, _mx in PKG.items():
    _register(_key, _mx)


# ---------------------------------------------------------------------------
# the six scenarios of tests/test_parity_modules.py, in both packages
# ---------------------------------------------------------------------------
def test_custom_op_imperative_and_grad_matches_jax():
    x0 = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    got = {}
    for key, mx in PKG.items():
        x = mx.nd.array(x0)
        y = mx.nd.Custom(x, op_type="sqr_tc", scale="3.0")
        x.attach_grad()
        with mx.autograd.record():
            loss = (mx.nd.Custom(x, op_type="sqr_tc", scale="2.0") *
                    mx.nd.array(x0 + 1.0)).sum()
        loss.backward()
        got[key] = (y.asnumpy(), float(loss.asnumpy()), x.grad.asnumpy())
    np.testing.assert_allclose(got["port"][0], 3 * x0 ** 2)
    for j, t in zip(got["jax"], got["port"]):
        _close(t, j)


def test_custom_op_symbolic_in_graph_matches_jax():
    x0 = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    w0 = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    got = {}
    for key, mx in PKG.items():
        data = mx.sym.var("data")
        fc = mx.sym.FullyConnected(data, num_hidden=4, no_bias=True,
                                   name="fc")
        s = mx.sym.sum(mx.sym.Custom(data=fc, op_type="sqr_tc",
                                     scale="1.5", name="sq"))
        args = {"data": mx.nd.array(x0), "fc_weight": mx.nd.array(w0)}
        grads = {k: mx.nd.zeros(v.shape) for k, v in args.items()}
        ex = s.bind(mx.cpu(), args, args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        got[key] = (out, grads["data"].asnumpy(),
                    grads["fc_weight"].asnumpy(), s.list_arguments(),
                    s.infer_shape(data=(2, 3)))
    for j, t in zip(got["jax"][:3], got["port"][:3]):
        _close(t, j)
    assert got["port"][3:] == got["jax"][3:]


def test_custom_op_kwargs_bind_by_name_not_order():
    for key, mx in PKG.items():
        a, b = mx.nd.array([10.0]), mx.nd.array([1.0])
        assert float(mx.nd.Custom(lhs=a, rhs=b,
                                  op_type="sub2_tc").asnumpy()) == 9.0
        assert float(mx.nd.Custom(rhs=b, lhs=a,
                                  op_type="sub2_tc").asnumpy()) == 9.0
        sa, sb = mx.sym.var("a"), mx.sym.var("b")
        ex = mx.sym.Custom(rhs=sb, lhs=sa, op_type="sub2_tc").bind(
            mx.cpu(), {"a": a, "b": b})
        assert float(ex.forward()[0].asnumpy()) == 9.0, key
        with pytest.raises(mx.MXNetError, match="not in its argument"):
            mx.nd.Custom(lhs=a, other=b, op_type="sub2_tc")


def test_custom_op_sees_real_is_train_flag():
    for key, mx in PKG.items():
        x = mx.nd.array([3.0])
        assert float(mx.nd.Custom(x, op_type="trainflag_tc").asnumpy()) == 3.0
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="trainflag_tc")
        assert float(y.asnumpy()) == 6.0, key
        s = mx.sym.Custom(data=mx.sym.var("d"), op_type="trainflag_tc")
        ex = s.bind(mx.cpu(), {"d": x})
        assert float(ex.forward(is_train=False)[0].asnumpy()) == 3.0
        assert float(ex.forward(is_train=True)[0].asnumpy()) == 6.0


def test_custom_op_unknown_type_errors():
    for mx in PKG.values():
        with pytest.raises(mx.MXNetError, match="not registered"):
            mx.nd.Custom(mx.nd.ones((2,)), op_type="no_such_op_tc")


def test_legacy_python_op_deprecated():
    for mx in PKG.values():
        for legacy in (mx.operator.NumpyOp, mx.operator.PythonOp,
                       mx.operator.NDArrayOp):
            with pytest.raises(mx.MXNetError, match="deprecated"):
                legacy()


# ---------------------------------------------------------------------------
# autograd, mirror, aux states, shape inference
# ---------------------------------------------------------------------------
def test_nd_custom_under_autograd_record_matches_jax():
    rng = np.random.RandomState(2)
    a0, b0, w0 = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    got = {}
    for key, mx in PKG.items():
        a, b = mx.nd.array(a0), mx.nd.array(b0)
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            d = mx.nd.Custom(rhs=b, lhs=a, op_type="sub2_tc")
            t = mx.nd.Custom(d, op_type="counted_tanh_tc")
            loss = (t * mx.nd.array(w0)).sum()
        loss.backward()
        got[key] = (t.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy())
    for j, t in zip(got["jax"], got["port"]):
        _close(t, j)
    np.testing.assert_allclose(got["port"][1], -got["port"][2])


def test_mirror_reruns_the_body_and_matches_jax(monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR=1``: the port's backward recomputes the
    Custom node, so its body runs twice a ``forward_backward`` (once
    without the knob); the gradients equal the JAX package's."""
    rng = np.random.RandomState(3)
    vals = {"data": rng.randn(4, 5), "fc_weight": rng.randn(3, 5) * 0.5,
            "fc_bias": rng.randn(3)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    grads = {}
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        for key, mx in PKG.items():
            data = mx.sym.var("data")
            fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
            net = mx.sym.sum(mx.sym.Custom(data=fc,
                                           op_type="counted_tanh_tc"))
            args = {k: mx.nd.array(v) for k, v in vals.items()}
            g = {k: mx.nd.zeros(v.shape) for k, v in vals.items()}
            ex = net.bind(mx.cpu(), args, args_grad=g)
            CALLS[key] = 0
            ex.forward(is_train=True)
            ex.backward()
            grads[(mirror, key)] = {k: v.asnumpy() for k, v in g.items()}
            if key == "port":
                assert CALLS[key] == (2 if mirror == "1" else 1), mirror
    for mirror in ("0", "1"):
        for k, v in grads[(mirror, "jax")].items():
            _close(grads[(mirror, "port")][k], v, k)


def test_prop_with_auxiliary_states_raises():
    for mx in PKG.values():
        with pytest.raises(mx.MXNetError, match="auxiliary states"):
            mx.nd.Custom(mx.nd.ones((2,)), op_type="with_aux_tc")


def test_shape_inference_never_calls_the_body():
    net = tmx.sym.Custom(data=tmx.sym.FullyConnected(
        tmx.sym.var("data"), num_hidden=6, name="fc"),
        op_type="counted_tanh_tc", name="t")
    CALLS["port"] = 0
    assert net.infer_shape(data=(2, 3)) == (
        [(2, 3), (6, 3), (6,)], [(2, 6)], [])
    assert net.infer_type(data=np.float32)[1] == [np.float32]
    ex = net.simple_bind(tmx.cpu(), data=(2, 3))
    assert CALLS["port"] == 0
    ex.forward()
    assert CALLS["port"] == 1
    jnet = jmx.sym.Custom(data=jmx.sym.FullyConnected(
        jmx.sym.var("data"), num_hidden=6, name="fc"),
        op_type="counted_tanh_tc", name="t")
    assert jnet.infer_shape(data=(2, 3)) == net.infer_shape(data=(2, 3))


# ---------------------------------------------------------------------------
# the numpy softmax loss head trained by Module.fit in both packages
# ---------------------------------------------------------------------------
TINY = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
FIT_BATCHES, BATCH = 3, 4
# sgd at lr 0.01 with momentum: at tests/test_torch_module.py's lr 0.1 the
# fused net's bn0 gamma (an exactly-zero gradient at this init) takes each
# package's own rounding noise and moves ReLU masks apart within a few
# updates; see that file's docstring
FIT_OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4)


def _mlp(mx):
    data = mx.sym.var("data")
    label = mx.sym.var("softmax_label")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=64)
    act1 = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=10)
    return mx.sym.Custom(data=fc2, label=label, op_type="numpy_softmax_tc",
                         name="softmax")


def _tiny_resnet(mx, resnet):
    """The tiny fused ResNet with the numpy softmax in place of its
    ``SoftmaxOutput`` head."""
    fc = resnet.resnet(fused=True, **TINY).get_internals()["fc1_output"]
    return mx.sym.Custom(data=fc, label=mx.sym.var("softmax_label"),
                         op_type="numpy_softmax_tc", name="softmax")


def _mnist(n):
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 784).astype(np.float32) * 0.1
    for i, lab in enumerate(y):
        x[i, 78 * int(lab):78 * int(lab) + 78] += 0.8
    return x, y.astype(np.float32)


def _images(n):
    rng = np.random.RandomState(4)
    return (rng.randn(n, 3, 64, 64).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.float32))


def _fit(mx, sym, x, y, args, auxs):
    """``Module.fit`` for one epoch of ``FIT_BATCHES`` batches from the
    given weights; the cross-entropy of every batch and the params after."""
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(sym, context=mx.cpu())
    losses = []

    def on_batch(param):
        p = mod.get_outputs()[0].asnumpy()
        lbl = param.locals["data_batch"].label[0].asnumpy().astype(int)
        losses.append(float(-np.log(p[np.arange(len(lbl)), lbl]).mean()))

    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=FIT_OPT,
            arg_params=args, aux_params=auxs, batch_end_callback=on_batch)
    a, x_ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in a.items()}, \
        {k: v.asnumpy() for k, v in x_.items()}


def _check_fits(got):
    (jl, ja, jx), (tl, ta, tx) = got["jax"], got["port"]
    assert len(jl) == len(tl) == FIT_BATCHES
    _close(tl, jl, "losses")
    assert np.isfinite(tl).all()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        _close(ta[k], ja[k], k)
    for k in jx:
        _close(tx[k], jx[k], k)


def test_numpy_softmax_head_trains_the_mlp_as_jax():
    x, y = _mnist(FIT_BATCHES * BATCH)
    shapes = dict(zip(_mlp(tmx).list_arguments(),
                      _mlp(tmx).infer_shape(data=(BATCH, 784),
                                            softmax_label=(BATCH,))[0]))
    rng = np.random.RandomState(5)
    w = {k: (rng.randn(*s) * 0.05).astype(np.float32)
         for k, s in shapes.items() if k not in ("data", "softmax_label")}
    got = {key: _fit(mx, _mlp(mx), x, y,
                     {k: mx.nd.array(v) for k, v in w.items()}, None)
           for key, mx in PKG.items()}
    _check_fits(got)


def test_numpy_softmax_head_trains_the_tiny_fused_resnet_as_jax():
    x, y = _images(FIT_BATCHES * BATCH)
    jsym = _tiny_resnet(jmx, jresnet)
    assert any(n.op is not None and n.op.name == "FusedBottleneckUnit"
               for n in jsym._topo())
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    jmod.bind([("data", (BATCH, 3, 64, 64))], [("softmax_label", (BATCH,))])
    jmx.random.seed(0)
    jmod.init_params(jmx.initializer.Xavier())
    ja, jx = (({k: v.asnumpy() for k, v in d.items()})
              for d in jmod.get_params())
    tsym = _tiny_resnet(tmx, tresnet)
    # the built-in head's graph has the same parameters, and its label's
    # shape follows from the data's (the Custom head's does not)
    ta, tx = tresnet.params_from_jax(
        ja, jx, tresnet.resnet(fused=True, **TINY), device="cpu",
        data_shape=(BATCH, 3, 64, 64))
    got = {"jax": _fit(jmx, jsym, x, y,
                       {k: jmx.nd.array(v) for k, v in ja.items()},
                       {k: jmx.nd.array(v) for k, v in jx.items()}),
           "port": _fit(tmx, tsym, x, y,
                        {k: tmx.nd.NDArray(v) for k, v in ta.items()},
                        {k: tmx.nd.NDArray(v) for k, v in tx.items()})}
    _check_fits(got)
