"""Gluon's core in the PyTorch port (``mxnet_tpu_torch/gluon``) against the
JAX package's ``mxnet_tpu.gluon``, on the CPU at small sizes.

Weights are carried from one package to the other by ``.params`` files
(``save_params`` in one, ``load_params`` in the other), never by seeding
alike: the packages' random initializers draw differently. Dropout's masks
cannot match the JAX package's, so layers are compared with dropout in
predict mode, and Dropout's training statistics are checked on their own.

- each of the 29 names of ``gluon.nn`` (parametrised cases): the forward
  and the gradients of the input and of every parameter, BatchNorm's
  running statistics after a training call;
- every loss class (and its variants): the loss and the prediction's
  gradient;
- ``hybridize()`` against the eager block and the JAX block, in training
  (with gradients) and predict mode, BatchNorm's running statistics after
  3 training calls;
- ``export``: the ``-symbol.json`` equal to the JAX package's for the same
  block, and each package's files loaded by the other's
  ``SymbolBlock.imports``;
- ``Trainer`` (sgd with momentum, adam) against the JAX Trainer after 3
  steps, the kvstore choices, and ``Trainer(kvstore=ServerKVStore)`` on the
  single-host server tier;
- the ``DataLoader``'s and samplers' order, ``split_data``,
  ``clip_global_norm``, ``download``;
- ``rnn``, ``contrib.rnn`` and ``data.vision`` resolve to the port's own
  classes (their parity is in ``tests/test_torch_rnn_gluon.py``);
- the scenario of ``tests/test_convergence.py``'s
  ``test_gluon_hybrid_conv_converges`` on the port.

Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-4, atol=1e-5)
PKG = {"port": (tmx, tgluon), "jax": (jmx, jgluon)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _carry(jblock, tblock, path):
    """The JAX block's parameters into the port block through a .params
    file."""
    jblock.save_params(path)
    tblock.initialize()
    tblock.load_params(path)


def _run(pkg, block, inputs, head, train, grad_input=True):
    """Output, input gradients and parameter gradients (by name less the
    block prefix) of ``(block(*inputs) * head).sum()``."""
    mx, _gluon = PKG[pkg]
    xs = [mx.nd.array(x) for x in inputs]
    if grad_input:
        for x in xs:
            x.attach_grad()
    params = block.collect_params()
    with mx.autograd.record(train_mode=train):
        out = block(*xs)
        loss = (out * mx.nd.array(head)).sum()
    # the JAX package evaluates the backward again in ``train_mode``
    loss.backward(train_mode=train)
    grads = {k[len(block.prefix):]: p.grad().asnumpy()
             for k, p in params.items() if p.grad_req != "null"}
    states = {k[len(block.prefix):]: p.data().asnumpy()
              for k, p in params.items() if p.grad_req == "null"}
    return (out.asnumpy(), [x.grad.asnumpy() for x in xs] if grad_input
            else [], grads, states)


def _hold_runs(got, want, what):
    for name, g, w in zip(("output", "input grads", "param grads",
                           "states"), got, want):
        if isinstance(w, dict):
            assert set(g) == set(w), (what, name)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], **TOL,
                                           err_msg="%s %s %s" % (what, name,
                                                                 k))
        elif isinstance(w, list):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, **TOL,
                                           err_msg="%s %s" % (what, name))
        else:
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg="%s %s" % (what, name))


# ---------------------------------------------------------------------------
# the 29 layers
# ---------------------------------------------------------------------------
X2 = (4, 6)
X3 = (2, 3, 9)
X4 = (2, 3, 8, 8)
X5 = (2, 2, 6, 6, 6)


def _seq(nn):
    net = nn.Sequential()
    with net.name_scope():
        net.add(nn.Dense(5, activation="tanh"), nn.Dense(3))
    return net


def _hseq(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(5), nn.Activation("relu"), nn.Dense(3))
    return net


LAYERS = {
    "Activation": (lambda nn: nn.Activation("tanh"), X2, False),
    "BatchNorm": (lambda nn: nn.BatchNorm(), X4, True),
    "Dense": (lambda nn: nn.Dense(5, activation="relu"), X4, False),
    "Dropout": (lambda nn: nn.Dropout(0.3), X2, False),
    "Embedding": (lambda nn: nn.Embedding(10, 4), (4, 5), False),
    "Flatten": (lambda nn: nn.Flatten(), X4, False),
    "HybridLambda": (lambda nn: nn.HybridLambda(lambda x: x * 2.0 + 1.0), X2,
                     False),
    "HybridSequential": (_hseq, X2, False),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(), X4, True),
    "Lambda": (lambda nn: nn.Lambda(lambda x: x * x), X2, False),
    "LayerNorm": (lambda nn: nn.LayerNorm(), X2, True),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.1), X2, False),
    "Sequential": (_seq, X2, False),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), X3, False),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, 1), X4, False),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2), X5, False),
    "Conv1D": (lambda nn: nn.Conv1D(4, 3, padding=1), X3, False),
    "Conv2D": (lambda nn: nn.Conv2D(4, 3, strides=2, padding=1), X4, False),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(4, 3, strides=2,
                                                      padding=1), X4, False),
    "Conv3D": (lambda nn: nn.Conv3D(2, 3), X5, False),
    "GlobalAvgPool1D": (lambda nn: nn.GlobalAvgPool1D(), X3, False),
    "GlobalAvgPool2D": (lambda nn: nn.GlobalAvgPool2D(), X4, False),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(), X5, False),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), X3, False),
    "GlobalMaxPool2D": (lambda nn: nn.GlobalMaxPool2D(), X4, False),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(), X5, False),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2), X3, False),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(2), X4, False),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2), X5, False),
}


def test_the_29_layer_names_are_the_jax_packages():
    names = {n for n in dir(jgluon.nn) if n[0].isupper()} - {
        "Block", "HybridBlock", "SymbolBlock"}
    assert names == set(LAYERS)
    assert all(hasattr(tgluon.nn, n) for n in names | {"Block", "HybridBlock",
                                                       "SymbolBlock"})


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name, tmp_path):
    make, shape, train = LAYERS[name]
    ids = name == "Embedding"
    x = np.random.RandomState(1).randint(0, 10, shape).astype(np.float32) \
        if ids else _rand(shape, 1)
    jb, tb = make(jgluon.nn), make(tgluon.nn)
    jb.initialize()
    jb(jmx.nd.array(x))                       # deferred shapes
    _carry(jb, tb, str(tmp_path / "w.params"))
    out = jb(jmx.nd.array(x)).asnumpy()
    head = _rand(out.shape, 2)
    want = _run("jax", jb, [x], head, train, grad_input=not ids)
    got = _run("port", tb, [x], head, train, grad_input=not ids)
    _hold_runs(got, want, name)
    if name in ("BatchNorm",):
        assert not np.allclose(got[3]["running_mean"], 0.0)


def test_dropout_statistics_in_training():
    """Dropout's training masks: about ``rate`` of the entries zeroed, the
    rest scaled by 1 / (1 - rate); predict mode is the identity."""
    drop = tgluon.nn.Dropout(0.3)
    x = tmx.nd.ones((200, 500))
    with tmx.autograd.record(train_mode=True):
        y = drop(x).asnumpy()
    assert abs((y == 0).mean() - 0.3) < 0.01
    np.testing.assert_allclose(y[y != 0], 1 / 0.7, rtol=1e-6)
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())


def test_parameter_surface():
    p = tgluon.Parameter("w", shape=(2, 0), allow_deferred_init=True)
    p.initialize(init="ones")
    with pytest.raises(tgluon.parameter.DeferredInitializationError):
        p.data()
    p.shape = (2, 3)
    p.set_data(np.full((2, 3), 5.0, np.float32))
    np.testing.assert_array_equal(p.data().asnumpy(), np.full((2, 3), 5.0))
    p.grad()[:] = 1
    p.zero_grad()
    assert p.grad().asnumpy().sum() == 0
    assert p.var().name == "w" and p.var() is p.var()
    p.cast("float16")
    assert p.data().dtype == np.float16
    c = tgluon.Constant("c", [[1.0, 2.0]])
    c.initialize()
    assert c.grad_req == "null"
    np.testing.assert_array_equal(c.data().asnumpy(), [[1.0, 2.0]])
    d = tgluon.ParameterDict("pre_")
    a = d.get("a", shape=(3,))
    assert d.get("a") is a and a.name == "pre_a"
    with pytest.raises(MXNetError, match="inconsistent"):
        d.get("a", lr_mult=2.0)
    with pytest.raises(MXNetError, match="not been initialized"):
        a.data()


def test_params_files_cross_load_both_ways(tmp_path):
    """A .params file of either package loads in the other with the same
    names, and the forwards agree."""
    x = _rand((3, 4, 6, 6), 3)
    for src, dst in ((jgluon, tgluon), (tgluon, jgluon)):
        mk = (lambda g: _conv_net(g.nn))
        a, b = mk(src), mk(dst)
        a.initialize(PKG["port" if src is tgluon else "jax"][0].init.Xavier())
        smx = PKG["port" if src is tgluon else "jax"][0]
        dmx = PKG["port" if dst is tgluon else "jax"][0]
        ya = a(smx.nd.array(x)).asnumpy()
        a.save_params(str(tmp_path / "n.params"))
        loaded = dmx.nd.load(str(tmp_path / "n.params"))
        assert sorted(loaded) == sorted(k[len(a.prefix):] for k in
                                        a.collect_params())
        b.initialize()
        b.load_params(str(tmp_path / "n.params"))
        np.testing.assert_allclose(b(dmx.nd.array(x)).asnumpy(), ya, **TOL)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
N, C = 4, 5
LOSSES = {
    "L2Loss": (lambda g: g.loss.L2Loss(), "reg"),
    "L1Loss": (lambda g: g.loss.L1Loss(), "reg"),
    "SigmoidBinaryCrossEntropyLoss": (
        lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(), "binary"),
    "SigmoidBCELoss_from_sigmoid": (
        lambda g: g.loss.SigmoidBCELoss(from_sigmoid=True), "prob"),
    "SoftmaxCrossEntropyLoss": (
        lambda g: g.loss.SoftmaxCrossEntropyLoss(), "sparse"),
    "SoftmaxCELoss_dense": (
        lambda g: g.loss.SoftmaxCELoss(sparse_label=False), "dense"),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(from_logits=False), "dense"),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.5), "reg"),
    "HingeLoss": (lambda g: g.loss.HingeLoss(), "signed"),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(), "signed"),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(), "signed"),
    "LogisticLoss_binary": (
        lambda g: g.loss.LogisticLoss(label_format="binary"), "binary"),
    "TripletLoss": (lambda g: g.loss.TripletLoss(), "triplet"),
    "CTCLoss": (lambda g: g.loss.CTCLoss(), "ctc"),
}


def _loss_inputs(kind):
    rng = np.random.RandomState(7)
    if kind == "ctc":
        pred = rng.randn(N, 8, C).astype(np.float32)
        label = rng.randint(0, C - 1, (N, 3)).astype(np.float32)
        return [pred], [label]
    pred = rng.randn(N, C).astype(np.float32)
    if kind == "prob":
        pred = 1 / (1 + np.exp(-pred))
    label = {
        "reg": lambda: rng.randn(N, C),
        "binary": lambda: rng.randint(0, 2, (N, C)),
        "prob": lambda: rng.randint(0, 2, (N, C)),
        "signed": lambda: rng.randint(0, 2, (N, C)) * 2 - 1,
        "sparse": lambda: rng.randint(0, C, (N,)),
        "dense": lambda: np.exp(rng.randn(N, C)) / np.exp(
            rng.randn(N, C)).sum(1, keepdims=True),
        "triplet": lambda: rng.randn(N, C),
    }[kind]().astype(np.float32)
    if kind == "triplet":
        return [pred], [label, rng.randn(N, C).astype(np.float32)]
    return [pred], [label]


def _loss_run(pkg, make, preds, others):
    mx, gluon = PKG[pkg]
    loss = make(gluon)
    xs = [mx.nd.array(p) for p in preds]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        out = loss(*xs, *[mx.nd.array(o) for o in others])
        total = (out * mx.nd.array(np.arange(1, N + 1, dtype=np.float32))
                 ).sum()
    total.backward()
    return out.asnumpy(), xs[0].grad.asnumpy()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    make, kind = LOSSES[name]
    preds, others = _loss_inputs(kind)
    got = _loss_run("port", make, preds, others)
    want = _loss_run("jax", make, preds, others)
    assert got[0].shape == (N,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


@pytest.mark.parametrize("name", ["SoftmaxCrossEntropyLoss", "L2Loss",
                                  "CTCLoss"])
def test_hybridized_loss_matches_eager(name):
    make, kind = LOSSES[name]
    preds, others = _loss_inputs(kind)
    loss = make(tgluon)
    args = [tmx.nd.array(a) for a in preds + others]
    eager = loss(*args).asnumpy()
    loss.hybridize()
    np.testing.assert_array_equal(loss(*args).asnumpy(), eager)


def test_every_loss_class_is_ported():
    names = {n for n in dir(jgluon.loss) if n.endswith("Loss")} - {"Loss"}
    assert names <= set(dir(tgluon.loss))
    covered = {type(make(tgluon)).__name__ for make, _ in LOSSES.values()}
    assert covered == {n for n in names if n not in ("SigmoidBCELoss",
                                                     "SoftmaxCELoss")}


# ---------------------------------------------------------------------------
# hybridize, export, SymbolBlock
# ---------------------------------------------------------------------------
def _conv_net(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Conv2D(8, 3),
                nn.BatchNorm(), nn.Activation("sigmoid"), nn.Flatten(),
                nn.Dense(5))
    return net


@pytest.mark.parametrize("train", [True, False], ids=["training", "predict"])
def test_hybridize_matches_eager_and_jax(train, tmp_path):
    """3 recorded calls of the same block eager, hybridized, and in the JAX
    package: outputs, input and parameter gradients, and BatchNorm's
    running statistics after them (updated once a training call)."""
    x = [_rand((4, 3, 8, 8), 10 + i) for i in range(3)]
    jb = _conv_net(jgluon.nn)
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x[0]))
    path = str(tmp_path / "w.params")
    jb.save_params(path)
    runs = {}
    for mode in ("eager", "hybrid", "jax"):
        if mode == "jax":
            b, pkg = jb, "jax"
        else:
            b, pkg = _conv_net(tgluon.nn), "port"
            b.initialize()
            b.load_params(path)
            if mode == "hybrid":
                b.hybridize()
        runs[mode] = [_run(pkg, b, [xi], _rand((4, 5), 20 + i), train)
                      for i, xi in enumerate(x)]
        if mode == "hybrid":
            assert len(b._cached) == 1
    for i in range(3):
        _hold_runs(runs["hybrid"][i], runs["eager"][i], "hybrid vs eager")
        _hold_runs(runs["hybrid"][i], runs["jax"][i], "hybrid vs jax")
    stats = runs["hybrid"][-1][3]
    if train:
        assert not np.allclose(stats["batchnorm0_running_mean"], 0.0)
    else:
        np.testing.assert_array_equal(stats["batchnorm0_running_mean"], 0.0)


def test_hybridize_keys_on_shape_training_and_recording():
    net = _conv_net(tgluon.nn)
    net.initialize()
    net(tmx.nd.ones((2, 3, 8, 8)))
    net.hybridize()
    net(tmx.nd.ones((2, 3, 8, 8)))
    net(tmx.nd.ones((2, 3, 8, 8)))
    net(tmx.nd.ones((3, 3, 8, 8)))
    with tmx.autograd.record():
        net(tmx.nd.ones((3, 3, 8, 8)))
    with tmx.autograd.train_mode():
        net(tmx.nd.ones((3, 3, 8, 8)))
    assert len(net._cached) == 4
    net.hybridize(False)
    assert net._cached == {} and not net._active


def _export_both(tmp_path):
    """The same block built, run and exported in each package inside a
    fresh NameManager, the port's carrying the JAX block's weights."""
    x = _rand((2, 3, 8, 8), 4)
    out = {}
    with jmx.name.NameManager():
        jb = _conv_net(jgluon.nn)
        jb.initialize(jmx.init.Xavier())
        out["jax_y"] = jb(jmx.nd.array(x)).asnumpy()
        jb.save_params(str(tmp_path / "w.params"))
        jb.export(str(tmp_path / "jax"))
    with tmx.name.NameManager():
        tb = _conv_net(tgluon.nn)
        tb.initialize()
        tb.load_params(str(tmp_path / "w.params"))
        out["port_y"] = tb(tmx.nd.array(x)).asnumpy()
        tb.export(str(tmp_path / "port"))
    return x, out


def test_export_json_equals_jax_and_cross_loads(tmp_path):
    x, out = _export_both(tmp_path)
    np.testing.assert_allclose(out["port_y"], out["jax_y"], **TOL)
    with open(tmp_path / "jax-symbol.json") as f:
        jjson = json.load(f)
    with open(tmp_path / "port-symbol.json") as f:
        tjson = json.load(f)
    assert tjson == jjson
    assert sorted(tmx.nd.load(str(tmp_path / "port-0000.params"))) == \
        sorted(jmx.nd.load(str(tmp_path / "jax-0000.params")))
    # each package's export through the other's SymbolBlock.imports
    tsb = tgluon.SymbolBlock.imports(str(tmp_path / "jax-symbol.json"),
                                     "data", str(tmp_path / "jax-0000.params"))
    np.testing.assert_allclose(tsb(tmx.nd.array(x)).asnumpy(), out["jax_y"],
                               **TOL)
    jsb = jgluon.SymbolBlock.imports(str(tmp_path / "port-symbol.json"),
                                     "data",
                                     str(tmp_path / "port-0000.params"))
    np.testing.assert_allclose(jsb(jmx.nd.array(x)).asnumpy(), out["port_y"],
                               **TOL)


def test_symbol_block_trains_through_torch_autograd(tmp_path):
    """A SymbolBlock's parameters take gradients, equal to the block it was
    exported from."""
    x, _ = _export_both(tmp_path)
    tb = tgluon.SymbolBlock.imports(str(tmp_path / "port-symbol.json"),
                                    "data",
                                    str(tmp_path / "port-0000.params"))
    ref = _conv_net(tgluon.nn)
    ref.initialize()
    ref.load_params(str(tmp_path / "w.params"))
    head = _rand((2, 5), 5)
    got = _run("port", tb, [x], head, train=False)
    want = _run("port", ref, [x], head, train=False)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1][0], want[1][0], **TOL)
    weight = [k for k in tb.params.keys() if k.endswith("_conv2d0_weight")]
    assert len(weight) == 1
    np.testing.assert_allclose(tb.params[weight[0]].grad().asnumpy(),
                               want[2]["conv2d0_weight"], **TOL)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def _mlp(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.BatchNorm(), nn.Dense(3))
    return net


def _train(pkg, path, opt, opt_params, kvstore="device", steps=3):
    mx, gluon = PKG[pkg]
    net = _mlp(gluon.nn)
    net.initialize()
    net(mx.nd.ones((2, 6)))
    net.load_params(path)
    trainer = gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                            kvstore=kvstore)
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, grads = [], []
    for i in range(steps):
        x = mx.nd.array(_rand((6, 6), 30 + i))
        y = mx.nd.array(np.arange(6) % 3)
        with mx.autograd.record():
            loss = lossf(net(x), y)
        loss.backward()
        grads.append({k[len(net.prefix):]: p.grad().asnumpy()
                      for k, p in net.collect_params().items()
                      if p.grad_req != "null"})
        trainer.step(6)
        losses.append(loss.asnumpy())
    return losses, {k[len(net.prefix):]: p.data().asnumpy()
                    for k, p in net.collect_params().items()}, grads


@pytest.fixture
def mlp_params(tmp_path):
    # The JAX package's initializers draw fresh entropy unless seeded: an
    # unseeded draw trains another net in every run.
    jmx.random.seed(0)
    net = _mlp(jgluon.nn)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.ones((2, 6)))
    path = str(tmp_path / "mlp.params")
    net.save_params(path)
    return path


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
    ("adam", dict(learning_rate=0.01, wd=1e-4)),
], ids=["sgd_momentum", "adam"])
def test_trainer_matches_jax_after_3_steps(mlp_params, opt, opt_params):
    got = _train("port", mlp_params, opt, opt_params)
    want = _train("jax", mlp_params, opt, opt_params)
    # A gradient whose exact value is 0 but which comes out as rounding
    # noise (dense0's bias over a channel that the ReLU passes on all 6
    # rows: BatchNorm subtracts the batch mean) is a coin toss in sign, and
    # Adam's first step turns the sign into a whole step. The drawn net
    # must have none, or the comparison below tests the rounding order.
    for step, (g, w) in enumerate(zip(got[2], want[2])):
        for k in w:
            scale = np.abs(w[k]).max()
            both_zero = (g[k] == 0) & (w[k] == 0)
            small = np.minimum(np.abs(g[k]), np.abs(w[k])) <= 1e-6 * scale
            assert not (small & ~both_zero).any(), (step, k)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], **TOL, err_msg=k)


def test_trainer_kvstore_choices_agree(mlp_params):
    opt = dict(learning_rate=0.1, momentum=0.9)
    runs = [_train("port", mlp_params, "sgd", opt, kvstore=kv)
            for kv in ("device", "local", None)]
    for other in runs[1:]:
        for k in runs[0][1]:
            np.testing.assert_array_equal(other[1][k], runs[0][1][k])


def test_trainer_on_the_server_tier_matches_jax(mlp_params):
    """``Trainer(kvstore=ServerKVStore)``: the servers run the optimizer
    (one push a parameter, one batched pull), in both packages."""
    from mxnet_tpu import kvstore_server as jks
    from mxnet_tpu_torch import kvstore_server as tks

    from torch_kvstore_helpers import _stop, _within

    def run(pkg):
        server = tks.KVStoreServer(device="cpu") if pkg == "port" \
            else jks.KVStoreServer()
        server.serve_in_background()
        kv = (tks if pkg == "port" else jks).ServerKVStore(server.addr)
        try:
            with tmx.cpu():     # the port's context is per thread
                return _train(pkg, mlp_params, "sgd",
                              dict(learning_rate=0.1, momentum=0.9),
                              kvstore=kv)
        finally:
            _stop(kv, server)

    got = _within(120, run, "port")
    want = _within(120, run, "jax")
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], **TOL, err_msg=k)


def test_trainer_update_and_allreduce_and_learning_rate(mlp_params):
    mx, gluon = tmx, tgluon
    net = _mlp(gluon.nn)
    net.initialize()
    net(mx.nd.ones((2, 6)))
    net.load_params(mlp_params)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    w = net.collect_params()[net.prefix + "dense0_weight"]
    before = w.data().asnumpy()
    with mx.autograd.record():
        loss = net(mx.nd.ones((2, 6))).sum()
    loss.backward()
    g = w.grad().asnumpy()
    tr.allreduce_grads()
    tr.update(2)
    np.testing.assert_allclose(w.data().asnumpy(), before - 0.25 * g / 2,
                               **TOL)


def test_trainer_states_cross_load(mlp_params, tmp_path):
    """A port Trainer's states (adam, after 2 steps) and weights, loaded by
    a fresh Trainer of each package: one more step in each lands on the
    same weights."""
    def net_and_trainer(pkg, params):
        mx, gluon = PKG[pkg]
        net = _mlp(gluon.nn)
        net.initialize()
        net(mx.nd.ones((2, 6)))
        net.load_params(params)
        return net, gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.01})

    def step(pkg, net, trainer, seed):
        mx, gluon = PKG[pkg]
        x = mx.nd.array(_rand((6, 6), seed))
        with mx.autograd.record():
            loss = gluon.loss.L2Loss()(net(x), mx.nd.zeros((6, 3)))
        loss.backward()
        trainer.step(6)

    net, trainer = net_and_trainer("port", mlp_params)
    for i in range(2):
        step("port", net, trainer, 40 + i)
    trainer.save_states(str(tmp_path / "t.states"))
    net.save_params(str(tmp_path / "t.params"))
    after = {}
    for pkg in ("port", "jax"):
        net, trainer = net_and_trainer(pkg, str(tmp_path / "t.params"))
        trainer.load_states(str(tmp_path / "t.states"))
        step(pkg, net, trainer, 50)
        after[pkg] = {k[len(net.prefix):]: p.data().asnumpy()
                      for k, p in net.collect_params().items()}
    for k, v in after["jax"].items():
        np.testing.assert_allclose(after["port"][k], v, **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# data, utils
# ---------------------------------------------------------------------------
def _batches(gluon, **kw):
    data = np.arange(23, dtype=np.float32).reshape(23, 1) * np.ones(
        (1, 2), np.float32)
    ds = gluon.data.ArrayDataset(data, np.arange(23))
    return [[b.asnumpy() for b in batch]
            for batch in gluon.data.DataLoader(ds, **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=5), dict(batch_size=5, last_batch="discard"),
    dict(batch_size=4, shuffle=True), dict(batch_size=5, num_workers=3),
    dict(batch_size=6, shuffle=True, num_workers=2, prefetch=1),
], ids=["keep", "discard", "shuffle", "workers", "shuffle_workers"])
def test_data_loader_order_matches_jax(kw):
    np.random.seed(11)
    got = _batches(tgluon, **kw)
    np.random.seed(11)
    want = _batches(jgluon, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_samplers_and_datasets_match_jax():
    for gluon in (tgluon, jgluon):
        sd = gluon.data.sampler if hasattr(gluon.data, "sampler") else None
        assert sd is not None
    seq = tgluon.data.SequentialSampler(7)
    roll = tgluon.data.BatchSampler(seq, 3, "rollover")
    jroll = jgluon.data.BatchSampler(jgluon.data.SequentialSampler(7), 3,
                                     "rollover")
    assert [list(roll), list(roll), len(roll)] == \
        [list(jroll), list(jroll), len(jroll)]
    ds = tgluon.data.SimpleDataset(list(range(6))).transform(lambda v: v * 3)
    jds = jgluon.data.SimpleDataset(list(range(6))).transform(
        lambda v: v * 3)
    assert [ds[i] for i in range(6)] == [jds[i] for i in range(6)]
    pairs = tgluon.data.ArrayDataset(np.arange(4), np.arange(4) * 2)
    tf = pairs.transform_first(lambda v: v + 100, lazy=False)
    assert [tuple(map(int, tf[i])) for i in range(4)] == \
        [(100, 0), (101, 2), (102, 4), (103, 6)]
    with pytest.raises(ValueError, match="last_batch"):
        list(tgluon.data.BatchSampler(seq, 3, "bogus"))


def test_split_and_clip_global_norm_match_jax():
    x = _rand((6, 4), 8)
    for axis in (0, 1):
        got = tgluon.utils.split_data(tmx.nd.array(x), 2, batch_axis=axis)
        want = jgluon.utils.split_data(jmx.nd.array(x), 2, batch_axis=axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(ValueError, match="evenly"):
        tgluon.utils.split_data(tmx.nd.array(x), 4)
    loaded = tgluon.utils.split_and_load(x, [tmx.cpu()])
    np.testing.assert_array_equal(loaded[0].asnumpy(), x)
    arrs = [_rand((3, 3), 12), _rand((5,), 13)]
    for scale in (0.5, 100.0):
        t = [tmx.nd.array(a * scale) for a in arrs]
        j = [jmx.nd.array(a * scale) for a in arrs]
        tn = tgluon.utils.clip_global_norm(t, 1.0)
        jn = jgluon.utils.clip_global_norm(j, 1.0)
        np.testing.assert_allclose(tn, jn, rtol=1e-6)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


def test_check_sha1_and_download(tmp_path):
    import hashlib

    f = tmp_path / "blob"
    f.write_bytes(b"abc")
    assert tgluon.utils.check_sha1(str(f), hashlib.sha1(b"abc").hexdigest())
    assert not tgluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError, match="download"):
        tgluon.utils.download("http://example.invalid/x")


def test_unported_submodules_raise_by_name():
    """The submodules this file once pinned as raising by name are ported:
    each name resolves to the port's own class."""
    from mxnet_tpu_torch.gluon.contrib import rnn as contrib_rnn
    from mxnet_tpu_torch.gluon.data.vision.datasets import MNIST
    from mxnet_tpu_torch.gluon.rnn.rnn_layer import LSTM

    assert tgluon.rnn.LSTM is LSTM
    assert tgluon.contrib.rnn is contrib_rnn
    assert tgluon.contrib.rnn.Conv2DLSTMCell.__module__ == \
        "mxnet_tpu_torch.gluon.contrib.rnn.conv_rnn_cell"
    assert tgluon.data.vision.MNIST is MNIST


# ---------------------------------------------------------------------------
# the convergence scenario of tests/test_convergence.py
# ---------------------------------------------------------------------------
def test_gluon_hybrid_conv_converges():
    """``test_gluon_hybrid_conv_converges`` on the port: a hybridized conv
    net with BatchNorm, ``Trainer.step`` and the softmax cross-entropy
    reaches 0.99 on the synthetic digits."""
    from test_convergence import _synth_images

    gluon, nd = tgluon, tmx.nd
    tmx.random.seed(7)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, kernel_size=5), gluon.nn.BatchNorm(),
            gluon.nn.Activation("relu"),
            gluon.nn.MaxPool2D(pool_size=2, strides=2),
            gluon.nn.Conv2D(16, kernel_size=5),
            gluon.nn.Activation("relu"),
            gluon.nn.MaxPool2D(pool_size=2, strides=2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(64, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(tmx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xt, yt = _synth_images(2000, seed=2)
    bs = 50
    for epoch in range(3):
        perm = np.random.RandomState(epoch).permutation(len(xt))
        for i in range(0, len(xt), bs):
            idx = perm[i:i + bs]
            with tmx.autograd.record():
                loss = loss_fn(net(nd.array(xt[idx])), nd.array(yt[idx]))
            loss.backward()
            trainer.step(bs)
    xv, yv = _synth_images(500, seed=3)
    pred = np.argmax(net(nd.array(xv)).asnumpy(), axis=1)
    acc = float((pred == yv).mean())
    assert acc >= 0.99, acc
