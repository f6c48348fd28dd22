"""The port's fused ``RNN`` op, its symbol rules and its initializers against
the JAX package's, on the CPU.

- The op in all four modes (lstm, gru, rnn_relu, rnn_tanh), 1 and 2
  layers, one and two directions, with ``state_outputs``: the outputs and
  final states, and the gradients of the data, the flat parameter vector
  and the initial states for one seeded cotangent on every output, against
  ``jax.vjp`` of the JAX op (rtol 1e-4, atol 1e-5). The parameter vector
  is the reference's layout, so one vector feeds both.
- Inter-layer dropout (``p > 0``) in training: a seeded draw repeats bit for
  bit and is not the ``p = 0`` result; in inference it is the ``p = 0``
  result.
- ``sym.RNN``: the auto-created ``parameters`` variable with its
  ``fusedrnn`` ``__init__`` attribute and lstm's ``state_cell``, Symbol
  JSON equal to the JAX symbol's, and the inferred shapes equal to JAX's.
- ``FusedRNN`` and ``LSTMBias`` fill bit-identical arrays from one seed, and
  an ``Executor`` bound on an ``RNN`` graph gives JAX's outputs.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.rnn import param_size

RTOL, ATOL = 1e-4, 1e-5
T, BATCH, IN, HID = 4, 3, 5, 6
MODES = ("lstm", "gru", "rnn_relu", "rnn_tanh")
CASES = list(itertools.product(MODES, (1, 2), (False, True)))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _inputs(mode, layers, bidirectional, seed=0):
    rng = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    size = param_size(mode, HID, layers, bidirectional, IN)
    ins = [rng.randn(T, BATCH, IN).astype(np.float32),
           rng.uniform(-0.3, 0.3, size).astype(np.float32),
           (0.5 * rng.randn(layers * d, BATCH, HID)).astype(np.float32)]
    if mode == "lstm":
        ins.append((0.5 * rng.randn(layers * d, BATCH, HID))
                   .astype(np.float32))
    return ins


def _attrs(mode, layers, bidirectional, **kw):
    return dict(state_size=HID, num_layers=layers,
                bidirectional=bidirectional, mode=mode, state_outputs=True,
                **kw)


def _torch_rnn(ins, attrs, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return treg.get("RNN").fn(gen, *ins, **attrs)


@pytest.mark.parametrize("mode,layers,bidirectional", CASES)
def test_rnn_forward_and_gradients_match_jax(mode, layers, bidirectional):
    ins = _inputs(mode, layers, bidirectional)
    attrs = _attrs(mode, layers, bidirectional)
    jfn = jreg.get("RNN").fn
    key = jax.random.PRNGKey(0)

    def f(*arrays):
        return jfn(key, *arrays, **attrs)

    jouts, vjp = jax.vjp(f, *[jnp.asarray(x) for x in ins])
    tens = [torch.tensor(x, requires_grad=True) for x in ins]
    touts = _torch_rnn(tens, attrs)
    assert len(touts) == len(jouts) == (3 if mode == "lstm" else 2)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg="output %d" % k)
    rng = np.random.RandomState(7)
    cots = [rng.randn(*j.shape).astype(np.float32) for j in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    tgrads = torch.autograd.grad(touts, tens,
                                 [torch.from_numpy(c) for c in cots])
    for name, t, j in zip(("data", "parameters", "state", "state_cell"),
                          tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_lstm_state_cell_defaults_to_zeros():
    ins = _inputs("lstm", 1, False)
    attrs = _attrs("lstm", 1, False)
    t = [torch.from_numpy(x) for x in ins]
    zeros = t[:3] + [torch.zeros_like(t[3])]
    for a, b in zip(_torch_rnn(t[:3], attrs), _torch_rnn(zeros, attrs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_interlayer_dropout_draws_in_training_only(mode):
    ins = [torch.from_numpy(x) for x in _inputs(mode, 2, True, seed=3)]
    plain = _torch_rnn(ins, _attrs(mode, 2, True))
    train = _attrs(mode, 2, True, p=0.5, __is_train__=True)
    first, again = _torch_rnn(ins, train, 5), _torch_rnn(ins, train, 5)
    other = _torch_rnn(ins, train, 6)
    assert torch.equal(first[0], again[0])
    assert not torch.equal(first[0], plain[0])
    assert not torch.equal(first[0], other[0])
    infer = _torch_rnn(ins, _attrs(mode, 2, True, p=0.5), 5)
    for a, b in zip(infer, plain):
        assert torch.equal(a, b)


def _rnn_symbols(pkg, names, **attrs):
    with names():
        return pkg.sym.RNN(pkg.sym.var("data"), name="rnn", **attrs)


@pytest.mark.parametrize("mode,bidirectional",
                         [("lstm", True), ("gru", False), ("rnn_tanh", True)])
def test_symbol_json_and_shapes_match_jax(mode, bidirectional):
    attrs = dict(state_size=HID, num_layers=2, mode=mode,
                 bidirectional=bidirectional, state_outputs=True)
    js = _rnn_symbols(jmx, jmx.name.NameManager, **attrs)
    ts = _rnn_symbols(mx, tname.NameManager, **attrs)
    assert ts.tojson() == js.tojson()
    want = ["data", "rnn_parameters", "rnn_state"] + (
        ["rnn_state_cell"] if mode == "lstm" else [])
    assert ts.list_arguments() == want
    init = ts.attr_dict()["rnn_parameters"]["__init__"]
    assert init == js.attr_dict()["rnn_parameters"]["__init__"]
    assert '"fusedrnn"' in init
    shapes = dict(data=(T, BATCH, IN))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    assert len(ts.list_outputs()) == (3 if mode == "lstm" else 2)


@pytest.mark.parametrize("mode,layers,bidirectional",
                         [("lstm", 2, True), ("lstm", 1, False),
                          ("gru", 2, False)])
def test_fused_rnn_initializer_matches_jax(mode, layers, bidirectional):
    size = param_size(mode, HID, layers, bidirectional, IN)
    kw = dict(num_hidden=HID, num_layers=layers, mode=mode,
              bidirectional=bidirectional, forget_bias=1.5)
    jmx.random.seed(4)
    want = jmx.nd.zeros((size,))
    jinit.FusedRNN(**kw)(jinit.InitDesc("rnn_parameters"), want)
    mx.random.seed(4)
    got = mx.nd.zeros((size,))
    tinit.FusedRNN(**kw)(tinit.InitDesc("rnn_parameters"), got)
    assert np.array_equal(got.asnumpy(), want.asnumpy())
    assert tinit.FusedRNN(**kw).dumps() == jinit.FusedRNN(**kw).dumps()


def test_lstm_bias_initializer_matches_jax():
    """Through a parameter's ``__init__`` attribute (a name ending in
    ``bias`` alone gets zeros)."""
    want, got = jmx.nd.zeros((4 * HID,)), mx.nd.zeros((4 * HID,))
    attrs = {"__init__": tinit.LSTMBias(forget_bias=2.0).dumps()}
    assert attrs["__init__"] == jinit.LSTMBias(forget_bias=2.0).dumps()
    jinit.Uniform()(jinit.InitDesc("lstm_i2h_bias", attrs), want)
    tinit.Uniform()(tinit.InitDesc("lstm_i2h_bias", attrs), got)
    assert np.array_equal(got.asnumpy(), want.asnumpy())
    assert got.asnumpy()[HID:2 * HID].tolist() == [2.0] * HID


def test_bound_rnn_graph_matches_jax():
    """The symbol's own initializer (the ``__init__`` attribute) through
    ``Module.init_params``, then a forward, in both packages."""
    attrs = dict(state_size=HID, num_layers=2, mode="lstm",
                 bidirectional=True, state_outputs=False)
    x = np.random.RandomState(9).randn(T, BATCH, IN).astype(np.float32)
    outs = []
    for pkg, names in ((jmx, jmx.name.NameManager),
                       (mx, tname.NameManager)):
        sym = _rnn_symbols(pkg, names, **attrs)
        mod = pkg.mod.Module(sym, data_names=("data",), label_names=(),
                             context=pkg.cpu())
        mod.bind([("data", x.shape)], for_training=False)
        pkg.random.seed(0)
        mod.init_params(pkg.init.Xavier())
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
