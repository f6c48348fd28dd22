"""The rest of the module front end in the PyTorch port against the JAX
package, on the CPU at small sizes: ``BucketingModule``,
``SequentialModule``, ``PythonModule``/``PythonLossModule`` and
``model.FeedForward``.

Weights go from the JAX module to the port's through ``.params`` files
(``save_params``/``load_params``, or a checkpoint for ``FeedForward``).

- ``BucketingModule``: every bucket's executor holds the default bucket's
  parameter and gradient arrays (the same storage, by ``data_ptr``) and
  the same updater, whose optimizer state is one tensor a parameter; a
  bucket-interleaved LSTM LM (buckets 4 and 8, sgd with momentum) equals
  the JAX package's batch by batch (outputs, then every parameter and
  momentum); the scenarios of ``tests/test_rnn.py``'s
  ``test_bucketing_module_variable_length_lm`` and ``tests/
  test_module.py``'s ``test_bucketing_module``;
- the three scenarios of ``tests/test_sequential_python_module.py`` and
  the five of ``tests/test_feedforward.py``, each in both packages.

Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

TOL = dict(rtol=1e-4, atol=1e-5)
PKG = {"jax": jmx, "port": tmx}
VOCAB, BATCH = 32, 8


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# BucketingModule
# ---------------------------------------------------------------------------
def _lstm_lm_sym(mx, seq_len, vocab=VOCAB, embed=8, hidden=16):
    """``tests/test_rnn.py``'s ``_lstm_lm_sym``."""
    data = mx.sym.var("data")
    label = mx.sym.var("softmax_label")
    emb = mx.sym.Embedding(data=data, input_dim=vocab, output_dim=embed,
                           name="embed")
    x = mx.sym.transpose(emb, axes=(1, 0, 2))
    rnn = mx.sym.RNN(data=x, state_size=hidden, num_layers=1, mode="lstm",
                     name="lstm")
    x = mx.sym.transpose(rnn, axes=(1, 0, 2))
    x = mx.sym.Reshape(x, shape=(-1, hidden))
    fc = mx.sym.FullyConnected(data=x, num_hidden=vocab, name="pred")
    lab = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(data=fc, label=lab, name="softmax")


def _bucketing(mx, default=8):
    def sym_gen(seq_len):
        with (JNameManager() if mx is jmx else TNameManager()):
            return (_lstm_lm_sym(mx, seq_len), ("data",),
                    ("softmax_label",))
    return mx.mod.BucketingModule(sym_gen, default_bucket_key=default,
                                  context=mx.cpu())


def _lm_batches(mx, lengths, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for seq_len in lengths:
        tokens = rng.randint(1, VOCAB, (BATCH, seq_len + 1))
        out.append(mx.io.DataBatch(
            data=[mx.nd.array(tokens[:, :-1].astype(np.float32))],
            label=[mx.nd.array(tokens[:, 1:].astype(np.float32))],
            bucket_key=seq_len,
            provide_data=[mx.io.DataDesc("data", (BATCH, seq_len))],
            provide_label=[mx.io.DataDesc("softmax_label",
                                          (BATCH, seq_len))]))
    return out


def _bound_pair(tmp_path, opt, opt_params):
    """Both packages' bucketing modules bound at bucket 8, the JAX one
    Xavier-initialized, its parameters loaded into the port's."""
    mods = {}
    for name, mx in PKG.items():
        mod = _bucketing(mx)
        mod.bind(data_shapes=[("data", (BATCH, 8))],
                 label_shapes=[("softmax_label", (BATCH, 8))])
        if mx is jmx:
            jmx.random.seed(0)
            mod.init_params(jmx.initializer.Xavier())
            mod.save_params(str(tmp_path / "lm.params"))
        else:
            mod.init_params()
            mod.load_params(str(tmp_path / "lm.params"))
        mod.init_optimizer(optimizer=opt, optimizer_params=opt_params)
        mods[name] = mod
    return mods


def _ptr(arr):
    return arr.tensor.untyped_storage().data_ptr()


def test_buckets_share_parameter_gradient_and_optimizer_storage(tmp_path):
    mods = _bound_pair(tmp_path, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    mod = mods["port"]
    for batch in _lm_batches(tmx, [8, 4, 6, 4]):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    default = mod._buckets[8]
    dgroup = default._exec_group
    assert sorted(mod._buckets) == [4, 6, 8]
    for key, bucket in mod._buckets.items():
        group = bucket._exec_group
        assert group.param_names == dgroup.param_names
        for a, b in zip(group.param_arrays, dgroup.param_arrays):
            assert a[0] is b[0] and _ptr(a[0]) == _ptr(b[0])
        for a, b in zip(group.grad_arrays, dgroup.grad_arrays):
            assert a[0] is b[0] and _ptr(a[0]) == _ptr(b[0])
        assert bucket._updater is default._updater
        assert bucket._optimizer is default._optimizer
        assert bucket._arg_params is default._arg_params
    # one momentum a parameter, kept where the updater keeps it
    states = default._updater.states
    assert sorted(states) == list(range(len(dgroup.param_names)))
    for i, arr in enumerate(dgroup.param_arrays):
        assert states[i].shape == arr[0].shape


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.05})])
def test_bucket_interleaved_training_matches_jax(tmp_path, opt, opt_params):
    mods = _bound_pair(tmp_path, opt, opt_params)
    lengths = [8, 4, 4, 8, 6, 4]
    batches = {name: _lm_batches(mx, lengths) for name, mx in PKG.items()}
    for i in range(len(lengths)):
        outs = {}
        for name, mod in mods.items():
            mod.forward(batches[name][i], is_train=True)
            outs[name] = mod.get_outputs()[0].asnumpy()
            mod.backward()
            mod.update()
        np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)
    jargs, _ = mods["jax"].get_params()
    targs, _ = mods["port"].get_params()
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        np.testing.assert_allclose(targs[k].asnumpy(), jargs[k].asnumpy(),
                                   err_msg=k, **TOL)
    jstates = mods["jax"]._buckets[8]._updater.states
    tstates = mods["port"]._buckets[8]._updater.states
    assert sorted(jstates) == sorted(tstates)

    def leaves(s):
        return [s] if not isinstance(s, (list, tuple)) else \
            [x for v in s for x in leaves(v)]

    for k in jstates:
        for j, t in zip(leaves(jstates[k]), leaves(tstates[k])):
            np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)


def test_bucketing_module_variable_length_lm():
    """``test_bucketing_module_variable_length_lm`` on the port: per-length
    graphs share parameters, and training lowers the perplexity."""
    buckets = [4, 8]
    mod = _bucketing(tmx)
    batches = _lm_batches(tmx, buckets * 3)
    mod.bind(data_shapes=[("data", (BATCH, 8))],
             label_shapes=[("softmax_label", (BATCH, 8))])
    tmx.random.seed(0)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.05})
    metric = tmx.metric.Perplexity(ignore_label=None)
    losses = []
    for _epoch in range(6):
        for batch in batches:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        metric.reset()
        mod.forward(batches[0], is_train=False)
        mod.update_metric(metric, batches[0].label)
        losses.append(metric.get()[1])
    assert losses[-1] < losses[0], losses


def test_bucketing_module_switches_buckets():
    """``tests/test_module.py``'s ``test_bucketing_module`` in both
    packages: an FC net over buckets 8 and 4 (their weights differ in
    shape, so each bucket binds its own), the same outputs."""
    outs = {}
    for name, mx in PKG.items():
        def sym_gen(seq_len, mx=mx):
            data = mx.sym.var("data")
            fc = mx.sym.FullyConnected(data=data, num_hidden=4, name="fc")
            out = mx.sym.SoftmaxOutput(
                data=fc, label=mx.sym.var("softmax_label"), name="softmax")
            return out, ("data",), ("softmax_label",)

        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                     context=mx.cpu())
        outs[name] = []
        for key in (8, 4):
            batch = mx.io.DataBatch(
                data=[mx.nd.ones((4, key))], label=[mx.nd.zeros((4,))],
                bucket_key=key,
                provide_data=[mx.io.DataDesc("data", (4, key))],
                provide_label=[mx.io.DataDesc("softmax_label", (4,))])
            if key == 8:
                mod.bind(data_shapes=batch.provide_data,
                         label_shapes=batch.provide_label)
                mod.init_params(mx.init.Constant(0.1))
                mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
            mod.forward_backward(batch)
            mod.update()
            outs[name].append(mod.get_outputs()[0].asnumpy())
        assert set(mod._buckets.keys()) == {8, 4}
    for j, t in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(t, j, **TOL)


# ---------------------------------------------------------------------------
# SequentialModule and PythonModule (tests/test_sequential_python_module.py)
# ---------------------------------------------------------------------------
def _toy_data(n=400, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 10).astype(np.float32)
    w = rng.randn(10, 3).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.float32)


def test_sequential_module_trains(tmp_path):
    """An FC trunk and a Python loss head chained by ``SequentialModule``:
    the first epoch equals the JAX package's batch by batch, and 8 epochs
    learn the separable task in the port."""
    x, y = _toy_data()
    preds = {}
    for name, mx in PKG.items():
        data = mx.sym.var("data")
        fc = mx.sym.FullyConnected(data=data, num_hidden=3, name="fc")
        trunk = mx.mod.Module(fc, context=mx.cpu(), label_names=None)
        seq = mx.mod.SequentialModule()
        seq.add(trunk).add(mx.mod.PythonLossModule(), take_labels=True,
                           auto_wiring=True)
        seq.bind(data_shapes=[("data", (40, 10))],
                 label_shapes=[("softmax_label", (40,))])
        if mx is jmx:
            jmx.random.seed(0)
            seq.init_params(jmx.init.Xavier())
            trunk.save_params(str(tmp_path / "t.params"))
        else:
            seq.init_params()
            trunk.load_params(str(tmp_path / "t.params"))
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        epochs = 1 if mx is jmx else 8
        outs = []
        for _epoch in range(epochs):
            for i in range(0, len(x), 40):
                batch = mx.io.DataBatch(data=[mx.nd.array(x[i:i + 40])],
                                        label=[mx.nd.array(y[i:i + 40])])
                seq.forward(batch, is_train=True)
                outs.append(seq.get_outputs()[0].asnumpy())
                seq.backward()
                seq.update()
        preds[name] = outs
        if mx is tmx:
            seq.forward(mx.io.DataBatch(data=[mx.nd.array(x)], label=None),
                        is_train=False)
            acc = float((np.argmax(seq.get_outputs()[0].asnumpy(), axis=1)
                         == y).mean())
            assert acc > 0.9, acc
    for j, t in zip(preds["jax"], preds["port"]):
        np.testing.assert_allclose(t, j, **TOL)


def _mono_and_seq(mx, x, y, w1, w2):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=5, no_bias=True,
                                name="l1")
    net = mx.sym.Activation(data=net, act_type="tanh")
    net = mx.sym.FullyConnected(data=net, num_hidden=4, no_bias=True,
                                name="l2")
    net = mx.sym.SoftmaxOutput(data=net, name="softmax")
    mono = mx.mod.Module(net, context=mx.cpu())
    mono.bind(data_shapes=[("data", (8, 6))],
              label_shapes=[("softmax_label", (8,))])
    mono.init_params()
    mono.set_params({"l1_weight": mx.nd.array(w1),
                     "l2_weight": mx.nd.array(w2)}, {})
    data = mx.sym.var("data")
    t = mx.sym.Activation(mx.sym.FullyConnected(
        data=data, num_hidden=5, no_bias=True, name="l1"), act_type="tanh")
    trunk = mx.mod.Module(t, context=mx.cpu(), label_names=None)
    data = mx.sym.var("data")
    h = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data=data, num_hidden=4, no_bias=True, name="l2"), name="softmax")
    head = mx.mod.Module(h, context=mx.cpu())
    seq = mx.mod.SequentialModule()
    seq.add(trunk).add(head, take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    seq.init_params()
    trunk.set_params({"l1_weight": mx.nd.array(w1)}, {}, allow_extra=True)
    head.set_params({"l2_weight": mx.nd.array(w2)}, {}, allow_extra=True)
    batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])
    mono.forward(batch, is_train=True)
    seq.forward(batch, is_train=True)
    mono.backward()
    seq.backward()

    def grads(m):
        g = m._exec_group
        return {n: a[0].asnumpy() for n, a in zip(g.param_names,
                                                  g.grad_arrays)}

    return (seq.get_outputs()[0].asnumpy(), mono.get_outputs()[0].asnumpy(),
            grads(trunk), grads(head), grads(mono))


def test_sequential_matches_monolithic():
    """Two chained FC modules equal the same net in one Module, gradient
    for gradient, and both equal the JAX package's."""
    np.random.seed(3)
    x = np.random.randn(8, 6).astype(np.float32)
    y = np.random.randint(0, 4, 8).astype(np.float32)
    w1 = np.random.randn(5, 6).astype(np.float32) * 0.3
    w2 = np.random.randn(4, 5).astype(np.float32) * 0.3
    got = {name: _mono_and_seq(mx, x, y, w1, w2) for name, mx in PKG.items()}
    seq_out, mono_out, g_t, g_h, g_mono = got["port"]
    np.testing.assert_allclose(seq_out, mono_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_t["l1_weight"], g_mono["l1_weight"], **TOL)
    np.testing.assert_allclose(g_h["l2_weight"], g_mono["l2_weight"], **TOL)
    jseq_out, _jm, jg_t, jg_h, _jg = got["jax"]
    np.testing.assert_allclose(seq_out, jseq_out, **TOL)
    np.testing.assert_allclose(g_t["l1_weight"], jg_t["l1_weight"], **TOL)
    np.testing.assert_allclose(g_h["l2_weight"], jg_h["l2_weight"], **TOL)


def test_python_module_shapes():
    outs = {}
    for name, mx in PKG.items():
        class Doubler(mx.mod.PythonModule):
            def __init__(self):
                super().__init__(["data"], [], ["double_output"])

            def _compute_output_shapes(self):
                return [("double_output", self._data_shapes[0].shape)]

            def forward(self, data_batch, is_train=None):
                self._out = [d * 2 for d in data_batch.data]

            def get_outputs(self, merge_multi_context=True):
                return self._out

        m = Doubler()
        m.bind(data_shapes=[("data", (2, 3))])
        m.init_params()
        assert m.output_shapes == [("double_output", (2, 3))]
        assert m.get_params() == ({}, {})
        m.forward(mx.io.DataBatch(data=[mx.nd.ones((2, 3))], label=None))
        outs[name] = m.get_outputs()[0].asnumpy()
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    np.testing.assert_allclose(outs["port"], 2.0)


def test_python_loss_module_gradient_matches_jax():
    """The loss head's default gradient (softmax minus one-hot) and a
    ``grad_func`` one equal the JAX package's."""
    scores = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    labels = np.array([0, 3, 1, 2, 2, 0], np.float32)
    got = {}
    for name, mx in PKG.items():
        got[name] = []
        for grad_func in (None, lambda s, lab: s * 3.0):
            m = mx.mod.PythonLossModule(grad_func=grad_func)
            m.bind(data_shapes=[("data", (6, 4))],
                   label_shapes=[("softmax_label", (6,))])
            m.forward(mx.io.DataBatch(data=[mx.nd.array(scores)],
                                      label=[mx.nd.array(labels)]),
                      is_train=True)
            m.backward()
            got[name].append(m.get_input_grads()[0].asnumpy())
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(t, j, **TOL)
    with pytest.raises(MXNetError):
        tmx.mod.PythonLossModule(grad_func=3)


# ---------------------------------------------------------------------------
# FeedForward (tests/test_feedforward.py)
# ---------------------------------------------------------------------------
def _problem(n=400, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 10).astype(np.float32)
    w = rng.randn(10, 3).astype(np.float32)
    return x, np.argmax(x @ w, 1).astype(np.float32)


def _net(mx):
    data = mx.sym.var("data")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(data, num_hidden=3, name="fc"), name="softmax")


def _init_params(seed=11):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.randn(3, 10).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(3, np.float32)}


def _fit_both(kw, x, y, seed=5):
    """Each package's FeedForward fitted from the same weights and the same
    numpy shuffles."""
    models = {}
    for name, mx in PKG.items():
        np.random.seed(seed)
        args = {k: mx.nd.array(v) for k, v in _init_params().items()}
        model = mx.model.FeedForward(_net(mx), ctx=mx.cpu(), arg_params=args,
                                     aux_params={}, **kw)
        model.fit(x, y)
        models[name] = model
    return models


def _same_params(models):
    j, t = models["jax"].arg_params, models["port"].arg_params
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_allclose(t[k].asnumpy(), j[k].asnumpy(),
                                   err_msg=k, **TOL)


def test_feedforward_fit_score_predict_roundtrip(tmp_path):
    x, y = _problem()
    models = _fit_both(dict(num_epoch=8, optimizer="sgd", learning_rate=0.5,
                            numpy_batch_size=40), x, y)
    _same_params(models)
    model = models["port"]
    it = tmx.io.NDArrayIter(x, y, 40, label_name="softmax_label")
    acc = model.score(it)
    assert acc > 0.9, acc
    pred = model.predict(x[:40])
    assert pred.shape == (40, 3)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(pred, models["jax"].predict(x[:40]), **TOL)
    # each package's checkpoint loads in the other
    for src, dst in (("port", tmx), ("jax", jmx)):
        prefix = str(tmp_path / ("ff_" + src))
        models[src].save(prefix)
        loaded = dst.model.FeedForward.load(prefix, 8, ctx=dst.cpu())
        it = dst.io.NDArrayIter(x, y, 40, label_name="softmax_label")
        assert abs(loaded.score(it) - acc) < 1e-6


def test_feedforward_create_with_iter():
    x, y = _problem(seed=1)
    models = {}
    for name, mx in PKG.items():
        np.random.seed(5)
        it = mx.io.NDArrayIter(x, y, 50, shuffle=True,
                               label_name="softmax_label")
        args = {k: mx.nd.array(v) for k, v in _init_params().items()}
        models[name] = mx.model.FeedForward.create(
            _net(mx), it, ctx=mx.cpu(), num_epoch=6, optimizer="sgd",
            learning_rate=0.5, arg_params=args, aux_params={})
    _same_params(models)
    val = tmx.io.NDArrayIter(x, y, 50, label_name="softmax_label")
    assert models["port"].score(val) > 0.9


def test_feedforward_fit_after_score(tmp_path):
    """``fit`` after ``predict``/``score`` rebinds for training and trains
    (the continued loss falls, the weights move), as in the JAX
    package."""
    x, y = _problem(seed=2)
    models = _fit_both(dict(num_epoch=2, optimizer="sgd", learning_rate=0.5,
                            numpy_batch_size=40), x, y)
    _same_params(models)
    model = models["port"]
    prefix = str(tmp_path / "ff2")
    model.save(prefix)
    loaded = tmx.model.FeedForward.load(prefix, 2, ctx=tmx.cpu(),
                                        num_epoch=6, optimizer="sgd",
                                        learning_rate=0.5)
    loaded.begin_epoch = 0

    def nll(m):
        p = np.clip(m.predict(x), 1e-9, None)
        return float(-np.log(p[np.arange(len(y)), y.astype(int)]).mean())

    before = nll(loaded)
    loaded.fit(x, y)
    after = nll(loaded)
    assert after < before, (before, after)
    assert not np.allclose(model.arg_params["fc_weight"].asnumpy(),
                           loaded.arg_params["fc_weight"].asnumpy())


def test_feedforward_num_epoch_required():
    x, y = _problem(seed=3)
    for mx in (jmx, tmx):
        model = mx.model.FeedForward(_net(mx), ctx=mx.cpu())
        with pytest.raises(mx.MXNetError, match="num_epoch"):
            model.fit(x, y)


def test_feedforward_return_data_and_composite_metric():
    x, y = _problem(seed=4)
    models = _fit_both(dict(num_epoch=4, optimizer="sgd", learning_rate=0.5,
                            numpy_batch_size=50), x, y)
    _same_params(models)
    got = {}
    for name, mx in PKG.items():
        it = mx.io.NDArrayIter(x, y, 50, label_name="softmax_label")
        outs, datas, labels = models[name].predict(it, return_data=True)
        assert outs.shape == (400, 3) and datas.shape == (400, 10)
        assert labels.shape == (400,)
        it.reset()
        values = models[name].score(it, eval_metric=["acc", "mse"])
        assert isinstance(values, list) and len(values) == 2
        got[name] = (outs, values)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], **TOL)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **TOL)
