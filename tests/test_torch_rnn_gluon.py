"""Gluon's recurrent layers and cells, ``gluon.contrib.rnn`` and
``gluon.data.vision`` in the PyTorch port against the JAX package, on the
CPU at small sizes (hidden 8, 1-2 layers, 5 steps).

Weights go from the JAX block to the port block through a ``.params``
file. Each case compares the output, the final states and the gradients of
the input and of every parameter of ``sum(out * head)``:

- the fused ``RNN`` (relu, tanh), ``LSTM`` and ``GRU`` layers, uni- and
  bidirectional, layouts TNC and NTC, with and without given states,
  eager and hybridized;
- ``RNNCell``, ``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``,
  ``ResidualCell``, ``ZoneoutCell`` and ``DropoutCell`` (p = 0),
  ``BidirectionalCell``, ``VariationalDropoutCell`` (p = 0) and
  ``Conv2DLSTMCell`` through ``unroll`` (with ``valid_length`` too), each
  eager and hybridized. The JAX package's hybridized cell cannot be
  stepped (its cached call drops the state list: ``RecurrentCell.forward()
  missing ... 'states'``), so the port's hybridized cells are held against
  the JAX eager ones; a hybridized block that unrolls a cell inside its
  forward is traced whole;
- the cells' random masks by rate (the packages' streams differ);
- the scenarios of ``tests/test_rnn.py`` (the bucketing one is in
  ``tests/test_torch_module_front.py``);
- the vision transforms, exactly under one ``np.random.seed``, and the
  datasets on small MNIST idx, CIFAR binary, RecordIO and folder files
  written under the test's directory;
- ``tests/test_vision.py``'s ``test_inception_v3_forward_and_hybrid`` and
  ``test_model_store_cache_layout`` on the port.

Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import gzip
import hashlib
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

TOL = dict(rtol=1e-4, atol=1e-5)
PKG = {"port": tmx, "jax": jmx}
T, N, C, H = 5, 3, 4, 8


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _pair(make, warm, path):
    """``make(mx)`` built in each package (fresh names in each), the JAX
    one Xavier-initialized, both run once by ``warm(mx, block)`` (deferred
    shapes), and the JAX weights loaded into the port's."""
    with JNameManager():
        jb = make(jmx)
    jb.initialize(jmx.init.Xavier())
    warm(jmx, jb)
    with TNameManager():
        tb = make(tmx)
    tb.initialize()
    warm(tmx, tb)
    # a modifier cell's parameters are its base cell's, under its prefix
    getattr(jb, "base_cell", jb).save_params(path)
    getattr(tb, "base_cell", tb).load_params(path)
    return jb, tb


def _grads(block):
    return {k[len(block.prefix):]: p.grad().asnumpy()
            for k, p in block.collect_params().items()
            if p.grad_req != "null"}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _run(mx, call, inputs, heads):
    """Outputs (flattened), input gradients and parameter gradients of
    ``sum(out_i * head_i)`` over the flattened outputs of ``call``."""
    xs = [mx.nd.array(x) for x in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = _flat(call(mx, *xs))
        loss = None
        for o, h in zip(outs, heads):
            term = (o * mx.nd.array(h)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs])


def _check(jb, tb, jcall, tcall, inputs, n_heads, hybridize):
    shapes = [o.shape for o in _flat(jcall(jmx, jb, *[
        jmx.nd.array(x) for x in inputs]))]
    heads = [_rand(shape, 10 + i) for i, shape in enumerate(shapes)]
    assert len(heads) == n_heads
    jouts, jin = _run(jmx, lambda mx, *xs: jcall(mx, jb, *xs), inputs,
                      heads)
    jg = _grads(jb)
    if hybridize:
        tb.hybridize()
    touts, tin = _run(tmx, lambda mx, *xs: tcall(mx, tb, *xs), inputs,
                      heads)
    tg = _grads(tb)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, **TOL)
    for j, t in zip(jin, tin):
        np.testing.assert_allclose(t, j, **TOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the fused layers
# ---------------------------------------------------------------------------
LAYERS = [("RNN", dict(activation="relu")), ("RNN", dict(activation="tanh")),
          ("LSTM", {}), ("GRU", {})]


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("kind,kw", LAYERS, ids=["rnn_relu", "rnn_tanh",
                                                 "lstm", "gru"])
def test_fused_layer_matches_jax(tmp_path, kind, kw, bidirectional,
                                 hybridize):
    def make(mx):
        return getattr(mx.gluon.rnn, kind)(H, num_layers=2,
                                            bidirectional=bidirectional,
                                            **kw)

    x = _rand((T, N, C))
    jb, tb = _pair(make, lambda mx, b: b(mx.nd.array(x)),
                   str(tmp_path / "p.params"))
    call = lambda mx, b, xx: b(xx)  # noqa: E731
    _check(jb, tb, call, call, [x], 1, hybridize)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_fused_layer_ntc_with_states_matches_jax(tmp_path, kind,
                                                 hybridize):
    """Layout NTC, the begin states given, the end states returned."""
    def make(mx):
        return getattr(mx.gluon.rnn, kind)(H, num_layers=1, layout="NTC",
                                            bidirectional=True)

    x = _rand((N, T, C))
    n_states = 2 if kind == "LSTM" else 1
    states = [_rand((2, N, H), 3 + i) for i in range(n_states)]
    jb, tb = _pair(make, lambda mx, b: b(mx.nd.array(x)),
                   str(tmp_path / "p.params"))

    def call(mx, b, xx, *ss):
        return b(xx, list(ss))

    _check(jb, tb, call, call, [x] + states, 1 + n_states, hybridize)


def test_fused_parameter_order_is_the_ops_unpack():
    """``_fused_parameters`` lays the weights out as ``ops/rnn.py``
    ``_unpack`` reads them: each view equals its parameter."""
    from mxnet_tpu_torch.ops.rnn import _unpack, param_size

    layer = tmx.gluon.rnn.LSTM(H, num_layers=2, bidirectional=True)
    layer.initialize(tmx.init.Xavier())
    layer(tmx.nd.array(_rand((T, N, C))))
    flat = layer._fused_parameters().tensor
    assert flat.numel() == param_size("lstm", H, 2, True, C)
    views = _unpack(flat, "lstm", H, 2, 2, C)
    for names, view in zip(layer._rnn_param_names, views):
        for name, t in zip(names, view):
            np.testing.assert_array_equal(
                t.numpy(), layer.params.get(name).data().asnumpy())


def test_deferred_init_infers_layer0_only():
    layer = tmx.gluon.rnn.GRU(H, num_layers=2)
    layer.initialize()
    layer(tmx.nd.array(_rand((T, N, C))))
    shapes = {k[len(layer.prefix):]: v.shape
              for k, v in layer.collect_params().items()}
    assert shapes["l0_i2h_weight"] == (3 * H, C)
    assert shapes["l1_i2h_weight"] == (3 * H, H)


# ---------------------------------------------------------------------------
# the cells through unroll
# ---------------------------------------------------------------------------
def _cell_maker(kind):
    def make(mx):
        rnn = mx.gluon.rnn
        if kind in ("RNNCell", "LSTMCell", "GRUCell"):
            return getattr(rnn, kind)(H)
        if kind == "sequential":
            cell = rnn.SequentialRNNCell()
            with cell.name_scope():
                cell.add(rnn.LSTMCell(H))
                cell.add(rnn.DropoutCell(0.0))
                cell.add(rnn.GRUCell(H))
            return cell
        if kind == "residual":
            return rnn.ResidualCell(rnn.GRUCell(C))
        if kind == "zoneout":
            return rnn.ZoneoutCell(rnn.LSTMCell(H), zoneout_outputs=0.0,
                                   zoneout_states=0.0)
        if kind == "bidirectional":
            return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="l_"),
                                         rnn.GRUCell(H, prefix="r_"))
        if kind == "vardrop":
            return mx.gluon.contrib.rnn.VariationalDropoutCell(
                rnn.LSTMCell(H), drop_inputs=0.0, drop_states=0.0,
                drop_outputs=0.0)
        raise ValueError(kind)
    return make


CELLS = ["RNNCell", "LSTMCell", "GRUCell", "sequential", "residual",
         "zoneout", "bidirectional", "vardrop"]


def _begin(mx, cell, n):
    return cell.begin_state(batch_size=n)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_jax(tmp_path, kind, layout, hybridize):
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = _rand(shape)

    def warm(mx, b):
        b.unroll(T, mx.nd.array(x), begin_state=_begin(mx, b, N),
                 layout=layout)

    jb, tb = _pair(_cell_maker(kind), warm, str(tmp_path / "c.params"))

    def jcall(mx, b, xx):
        return b.unroll(T, xx, begin_state=_begin(mx, b, N), layout=layout)

    def tcall(mx, b, xx):
        # the port also makes its own zero begin state
        return b.unroll(T, xx, layout=layout)

    n_states = len(jb.state_info(N))
    _check(jb, tb, jcall, tcall, [x], 1 + n_states, hybridize)


@pytest.mark.parametrize("kind", ["LSTMCell", "bidirectional"])
def test_cell_unroll_valid_length_matches_jax(tmp_path, kind):
    x = _rand((N, T, C))
    valid = np.array([2, 5, 3], np.float32)

    def warm(mx, b):
        b.unroll(T, mx.nd.array(x), begin_state=_begin(mx, b, N))

    jb, tb = _pair(_cell_maker(kind), warm, str(tmp_path / "c.params"))

    def call(mx, b, xx):
        return b.unroll(T, xx, begin_state=_begin(mx, b, N),
                        valid_length=mx.nd.array(valid))

    _check(jb, tb, call, call, [x], 1 + len(jb.state_info(N)), False)


def test_unroll_without_merge_gives_steps(tmp_path):
    x = _rand((N, T, C))

    def warm(mx, b):
        b.unroll(T, mx.nd.array(x), begin_state=_begin(mx, b, N))

    jb, tb = _pair(_cell_maker("GRUCell"), warm, str(tmp_path / "c.params"))
    jo, _ = jb.unroll(T, jmx.nd.array(x), begin_state=_begin(jmx, jb, N),
                      merge_outputs=False)
    to, _ = tb.unroll(T, tmx.nd.array(x), merge_outputs=False)
    assert len(to) == T
    for j, t in zip(jo, to):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)


def test_cell_unroll_equals_fused_layer():
    """``LSTMCell.unroll`` with the fused layer's weights gives the fused
    layer's outputs and end states."""
    x = _rand((T, N, C))
    layer = tmx.gluon.rnn.LSTM(H)
    layer.initialize(tmx.init.Xavier())
    out, (h, c) = layer(tmx.nd.array(x), layer.begin_state(N))
    cell = tmx.gluon.rnn.LSTMCell(H, input_size=C)
    cell.initialize()
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(layer.params.get("l0_" + name).data())
    cout, (ch, cc) = cell.unroll(T, tmx.nd.array(x), layout="TNC")
    np.testing.assert_allclose(cout.asnumpy(), out.asnumpy(), **TOL)
    np.testing.assert_allclose(ch.asnumpy(), h.asnumpy()[0], **TOL)
    np.testing.assert_allclose(cc.asnumpy(), c.asnumpy()[0], **TOL)


def test_hybridized_block_unrolls_a_cell_in_one_trace(tmp_path):
    """A hybridized block whose forward unrolls a cell (begin states made
    from the input inside the trace) equals the JAX block."""
    def make(mx):
        class Net(mx.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.cell = mx.gluon.rnn.LSTMCell(H)
                    self.out = mx.gluon.nn.Dense(2, flatten=False)

            def forward(self, x):
                if isinstance(x, mx.nd.NDArray):
                    begin = self.cell.begin_state(batch_size=x.shape[0])
                else:
                    begin = None
                seq, _ = self.cell.unroll(T, x, begin_state=begin)
                return self.out(seq)
        return Net()

    x = _rand((N, T, C))
    jb, tb = _pair(make, lambda mx, b: b(mx.nd.array(x)),
                   str(tmp_path / "n.params"))
    tb.hybridize()
    call = lambda mx, b, xx: b(xx)  # noqa: E731
    _check(jb, tb, call, call, [x], 1, True)
    assert len(tb._cached) == 1


@pytest.mark.parametrize("hybridize", [False, True])
def test_conv2d_lstm_cell_matches_jax(tmp_path, hybridize):
    shape = (2, 6, 6)

    def make(mx):
        return mx.gluon.contrib.rnn.Conv2DLSTMCell(
            input_shape=shape, hidden_channels=4, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)

    x = _rand((N, 3) + shape)

    def warm(mx, b):
        b.unroll(3, mx.nd.array(x), begin_state=_begin(mx, b, N))

    jb, tb = _pair(make, warm, str(tmp_path / "c.params"))

    def call(mx, b, xx):
        return b.unroll(3, xx, begin_state=_begin(mx, b, N))

    _check(jb, tb, call, call, [x], 3, hybridize)


def test_bidirectional_cell_cannot_step():
    cell = tmx.gluon.rnn.BidirectionalCell(tmx.gluon.rnn.LSTMCell(H),
                                           tmx.gluon.rnn.LSTMCell(H))
    with pytest.raises(MXNetError, match="unroll"):
        cell(tmx.nd.ones((N, C)), cell.begin_state(batch_size=N))


def test_begin_state_func_builds_symbols():
    """``begin_state(func=sym.zeros)`` composes zero nodes of the state
    shapes, as in the JAX package."""
    cell = tmx.gluon.rnn.LSTMCell(H)
    states = cell.begin_state(batch_size=N, func=tmx.sym.zeros)
    assert len(states) == 2
    for s in states:
        _args, outs, _aux = s.infer_shape()
        assert outs == [(N, H)]
    layer = tmx.gluon.rnn.GRU(H, num_layers=2)
    (s,) = layer.begin_state(N, func=tmx.sym.zeros)
    assert s.infer_shape()[1] == [(2, N, H)]


# ---------------------------------------------------------------------------
# random masks, by rate
# ---------------------------------------------------------------------------
def test_dropout_and_zoneout_mask_rates():
    tmx.random.seed(3)
    x = tmx.nd.ones((400, 50))
    with tmx.autograd.record():
        out, _ = tmx.gluon.rnn.DropoutCell(0.3)(x, [])
    kept = (out.asnumpy() != 0).mean()
    assert abs(kept - 0.7) < 0.02, kept
    np.testing.assert_allclose(out.asnumpy()[out.asnumpy() != 0], 1 / 0.7,
                               rtol=1e-6)
    # zoneout keeps the previous output (zeros at step 0) at rate p
    base = tmx.gluon.rnn.RNNCell(50, activation="relu")
    cell = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=0.4)
    cell.initialize(tmx.init.One())
    out, _ = cell(x, cell.begin_state(batch_size=400))
    zoned = (out.asnumpy() == 0).mean()
    assert abs(zoned - 0.4) < 0.02, zoned


def test_variational_dropout_mask_is_shared_over_time():
    tmx.random.seed(4)
    base = tmx.gluon.rnn.RNNCell(6, activation="relu")
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(base,
                                                        drop_inputs=0.5)
    cell.initialize(tmx.init.One())
    seen = []
    base.register_forward_hook(lambda b, args, out: seen.append(
        args[0].asnumpy()))
    cell.unroll(T, tmx.nd.ones((200, T, 6)))
    assert len(seen) == T
    assert abs((seen[0] != 0).mean() - 0.5) < 0.05
    for step in seen[1:]:
        np.testing.assert_array_equal(step, seen[0])
    # the next sequence draws a mask of its own
    first = seen[0]
    seen.clear()
    cell.unroll(T, tmx.nd.ones((200, T, 6)))
    np.testing.assert_array_equal(seen[-1], seen[0])
    assert (seen[0] != first).any()


# ---------------------------------------------------------------------------
# the scenarios of tests/test_rnn.py
# ---------------------------------------------------------------------------
def test_fused_rnn_lstm_shapes_and_grad(tmp_path):
    """``test_fused_rnn_lstm_shapes_and_grad`` in both packages: shapes,
    then the 2-layer LSTM's output and gradients equal."""
    x = np.random.RandomState(0).randn(T, N, C).astype(np.float32)
    for mx in (jmx, tmx):
        rnn = mx.gluon.rnn.LSTM(H, num_layers=2)
        rnn.initialize()
        assert rnn(mx.nd.array(x)).shape == (T, N, H)
        birnn = mx.gluon.rnn.LSTM(H, num_layers=1, bidirectional=True)
        birnn.initialize()
        assert birnn(mx.nd.array(x)).shape == (T, N, 2 * H)
    jb, tb = _pair(lambda mx: mx.gluon.rnn.LSTM(H, num_layers=2),
                   lambda mx, b: b(mx.nd.array(x)),
                   str(tmp_path / "l.params"))
    call = lambda mx, b, xx: b(xx)  # noqa: E731
    _check(jb, tb, call, call, [x], 1, False)


def _sum_net(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.rnn.RNN(16, num_layers=1))
        net.add(mx.gluon.nn.Dense(1, flatten=False))
    return net


def test_gluon_lstm_learns_sequence_sum(tmp_path):
    """``test_gluon_lstm_learns_sequence_sum``: the RNN + Dense net under
    adam; 5 steps equal the JAX package's step for step, and 60 steps on
    the port halve the loss."""
    rng = np.random.RandomState(0)
    x_np = rng.uniform(-1, 1, (8, 16, 1)).astype(np.float32)
    y_np = np.cumsum(x_np, axis=0)
    jb, tb = _pair(_sum_net, lambda mx, b: b(mx.nd.array(x_np)),
                   str(tmp_path / "s.params"))
    losses = {}
    for name, mx, net, steps in (("jax", jmx, jb, 5), ("port", tmx, tb, 60)):
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.02})
        loss_fn = mx.gluon.loss.L2Loss()
        x, y = mx.nd.array(x_np), mx.nd.array(y_np)
        losses[name] = []
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(16)
            losses[name].append(float(loss.mean().asnumpy()))
    np.testing.assert_allclose(losses["port"][:5], losses["jax"], rtol=1e-4)
    assert losses["port"][-1] < losses["port"][0] * 0.5, losses["port"]


def test_sequence_ops_padded_batch():
    """``test_sequence_ops_padded_batch``: SequenceMask/Last/Reverse on a
    padded batch equal the JAX package's."""
    x = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    lens = np.array([2, 4], np.float32)
    got = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        xx, ll = mx.nd.array(x), mx.nd.array(lens)
        got[name] = [
            mx.nd.SequenceMask(xx, sequence_length=ll,
                               use_sequence_length=True).asnumpy(),
            mx.nd.SequenceLast(xx, sequence_length=ll,
                               use_sequence_length=True).asnumpy(),
            mx.nd.SequenceReverse(xx, sequence_length=ll,
                                  use_sequence_length=True).asnumpy()]
    masked = got["port"][0]
    assert masked[2:, 0].sum() == 0
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# gluon.data.vision
# ---------------------------------------------------------------------------
def _image(seed, shape=(20, 24, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _transforms(mx):
    tf = mx.gluon.data.vision.transforms
    return {
        "flip_lr": tf.RandomFlipLeftRight(),
        "flip_tb": tf.RandomFlipTopBottom(),
        "center": tf.CenterCrop((10, 8)),
        "resize": tf.Resize((12, 9)),
        "upsize": tf.Resize(30),
        "rrc": tf.RandomResizedCrop(8),
        "chain": tf.Compose([tf.RandomResizedCrop((10, 12), scale=(0.3, 1)),
                             tf.RandomFlipLeftRight(), tf.ToTensor(),
                             tf.Normalize((0.5, 0.4, 0.3),
                                          (0.2, 0.25, 0.3))]),
        "cast": tf.Cast("float16"),
    }


RESIZING = ("resize", "upsize", "rrc", "chain")


@pytest.mark.parametrize("name", ["flip_lr", "flip_tb", "center", "resize",
                                  "upsize", "rrc", "chain", "cast"])
def test_transforms_match_jax_exactly(name):
    """Under one ``np.random.seed`` each transform gives the JAX package's
    output for 8 images in a row (the draws stay in step: the same crops
    and flips). Crops, flips, casts and ``ToTensor``/``Normalize`` are
    exact. A bilinear resize has the JAX weights bit for bit, but its two
    float32 products sum in another order than XLA's, which can move a
    value across a uint8 boundary, so a resizing transform is held to one
    uint8 level (1/255 after ``ToTensor``, over the std) on at most 1% of
    its values over the 8 images."""
    outs = {}
    for pkg, mx in PKG.items():
        t = _transforms(mx)[name]
        np.random.seed(7)
        outs[pkg] = [t(mx.nd.array(_image(i), dtype=np.uint8)).asnumpy()
                     for i in range(8)]
    gaps = []
    for j, t in zip(outs["jax"], outs["port"]):
        assert j.dtype == t.dtype and j.shape == t.shape
        if name not in RESIZING:
            np.testing.assert_array_equal(t, j)
            continue
        level = 1.0 if j.dtype == np.uint8 else 1.0 / 255 / 0.2 + 1e-6
        gaps.append(np.abs(t.astype(np.float64) - j.astype(np.float64)))
        assert gaps[-1].max() <= level, gaps[-1].max()
    if gaps:
        off = np.concatenate([g.ravel() for g in gaps]) > 1e-6
        assert off.mean() <= 0.01, off.mean()


def _write_mnist(root, n, gz):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with op(os.path.join(root, "train-images-idx3-ubyte" + suffix),
            "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with op(os.path.join(root, "train-labels-idx1-ubyte" + suffix),
            "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_reads_local_idx_files(tmp_path, gz):
    images, labels = _write_mnist(str(tmp_path), 6, gz)
    for mx in (jmx, tmx):
        ds = mx.gluon.data.vision.MNIST(root=str(tmp_path), train=True)
        assert len(ds) == 6
        img, lab = ds[4]
        np.testing.assert_array_equal(img.asnumpy()[..., 0], images[4])
        assert int(lab) == labels[4]
    ds = tmx.gluon.data.vision.FashionMNIST(
        root=str(tmp_path), transform=lambda d, l: (d.astype("float32"), l))
    assert ds[0][0].dtype == np.float32
    with pytest.raises(MXNetError, match="not found"):
        tmx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)


def test_cifar_read_local_binary_batches(tmp_path):
    rng = np.random.RandomState(2)
    d10 = tmp_path / "c10" / "cifar-10-batches-bin"
    d10.mkdir(parents=True)
    rows = []
    for i in range(1, 6):
        r = rng.randint(0, 256, (2, 3073)).astype(np.uint8)
        r[:, 0] %= 10
        rows.append(r)
        (d10 / ("data_batch_%d.bin" % i)).write_bytes(r.tobytes())
    d100 = tmp_path / "c100"
    d100.mkdir()
    r100 = rng.randint(0, 100, (3, 3074)).astype(np.uint8)
    (d100 / "train.bin").write_bytes(r100.tobytes())
    for mx in (jmx, tmx):
        vision = mx.gluon.data.vision
        ds = vision.CIFAR10(root=str(tmp_path / "c10"))
        assert len(ds) == 10
        img, lab = ds[7]
        want = rows[3][1]
        np.testing.assert_array_equal(
            img.asnumpy(), want[1:].reshape(3, 32, 32).transpose(1, 2, 0))
        assert int(lab) == want[0]
        for fine in (False, True):
            ds = vision.CIFAR100(root=str(tmp_path / "c100"),
                                 fine_label=fine)
            img, lab = ds[2]
            assert int(lab) == r100[2][int(fine)]
            np.testing.assert_array_equal(
                img.asnumpy(),
                r100[2][2:].reshape(3, 32, 32).transpose(1, 2, 0))


def test_image_record_and_folder_datasets(tmp_path):
    import io

    from mxnet_tpu_torch import recordio

    imgs = [_image(i, (6, 5, 3)) for i in range(3)]
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                     str(tmp_path / "d.rec"), "w")
    for i, im in enumerate(imgs):
        buf = io.BytesIO()
        np.save(buf, im)
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                       buf.getvalue()))
    rec.close()
    for cls in ("cat", "dog"):
        (tmp_path / "folder" / cls).mkdir(parents=True)
    np.save(tmp_path / "folder" / "cat" / "a.npy", imgs[0])
    np.save(tmp_path / "folder" / "dog" / "b.npy", imgs[1])
    (tmp_path / "folder" / "dog" / "skip.txt").write_text("x")
    for mx in (jmx, tmx):
        vision = mx.gluon.data.vision
        ds = vision.ImageRecordDataset(str(tmp_path / "d.rec"))
        assert len(ds) == 3
        img, lab = ds[2]
        np.testing.assert_array_equal(img.asnumpy(), imgs[2])
        assert lab == 2.0
        ds = vision.ImageFolderDataset(str(tmp_path / "folder"))
        assert ds.synsets == ["cat", "dog"] and len(ds) == 2
        img, lab = ds[1]
        np.testing.assert_array_equal(img.asnumpy(), imgs[1])
        assert lab == 1


# ---------------------------------------------------------------------------
# tests/test_vision.py's scenarios
# ---------------------------------------------------------------------------
def test_inception_v3_forward_and_hybrid(tmp_path):
    """Inception3: the port's eager and hybridized outputs agree with each
    other and with the JAX network of the same weights; the head is
    (N, classes)."""
    x = np.random.RandomState(0).rand(1, 3, 299, 299).astype(np.float32)

    def make(mx):
        return mx.gluon.model_zoo.vision.get_model("inceptionv3", classes=7)

    jb, tb = _pair(make, lambda mx, b: b(mx.nd.array(x)),
                   str(tmp_path / "i.params"))
    want = jb(jmx.nd.array(x)).asnumpy()
    y = tb(tmx.nd.array(x))
    assert y.shape == (1, 7)
    tb.hybridize()
    y2 = tb(tmx.nd.array(x))
    np.testing.assert_allclose(y2.asnumpy(), y.asnumpy(), atol=1e-4)
    np.testing.assert_allclose(y.asnumpy(), want, rtol=1e-4, atol=1e-4)


def test_model_store_cache_layout(tmp_path, monkeypatch):
    """``get_model_file`` finds a correctly hashed cached file, copies one
    from an air-gapped ``MXNET_GLUON_REPO`` directory, and without either
    raises at once."""
    from mxnet_tpu_torch.gluon.model_zoo import model_store

    payload = b"not-really-params"
    sha = hashlib.sha1(payload).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "inceptionv3", sha)
    name = "inceptionv3-%s.params" % sha[:8]
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / name).write_bytes(payload)
    got = model_store.get_model_file("inceptionv3", root=str(cache))
    assert got == str(cache / name)
    repo = tmp_path / "repo"
    repo.mkdir()
    (repo / name).write_bytes(payload)
    monkeypatch.setenv("MXNET_GLUON_REPO", str(repo))
    got = model_store.get_model_file("inceptionv3",
                                     root=str(tmp_path / "cache2"))
    assert os.path.exists(got)
    monkeypatch.delenv("MXNET_GLUON_REPO")
    with pytest.raises(MXNetError):
        model_store.get_model_file("inceptionv3",
                                   root=str(tmp_path / "cache3"))
    model_store.purge(str(cache))
    assert not list(cache.glob("*.params"))
