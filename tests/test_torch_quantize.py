"""Int8 post-training-quantized serving in the port (``ops/quantized.py``,
``ir/quantize.py``, ``AOTPredictor(quant="int8")``,
``ModelServer.swap_from_checkpoint``) against the JAX package on the CPU.

The same seeded numpy inputs and weights go through both packages:

- bit for bit: ``_quantize_int8`` (at k + 0.5 steps of the scale and one
  ulp either side) and ``_quantize_rows_int8`` against the JAX ops; the
  rewritten symbol's op list and node names against
  ``mxnet_tpu.ir.quantize_for_serving``'s; ``quantized_ops`` of the bench
  MLP (4), the small conv net (3) and the unfused ResNet-50;
- the calibration scales within rtol 1e-6;
- ``_int8_fully_connected`` and ``_int8_convolution`` within rtol 1e-5 /
  atol 1e-5 (both packages carry the int8 values in float32 on the CPU and
  differ only in summation order);
- the reference's int8 scenarios (``tests/test_ir_passes.py``) re-run on
  the port: the trained MLP's int8 logits and top-1 against the JAX
  predictor's (logits within 1e-4 of the largest), agreement with bf16
  >= 0.99, a swap requantizes, the calibration and knob errors, a computed
  bias and 1-D convolutions left float.

The MLP is ``tools/bench_serve.py``'s ``build_model(64, 128, 3, 16)``,
trained by its ``_train_model`` (5 epochs on 2048 rows) in the JAX package.

The card's routes (``torch._int_mm`` and the exact float32 route of a
grouped convolution) are held against float64 of the same int8 operands,
bit for bit, by the ``cuda`` case on the card, and here by running the same
code on the CPU, where ``torch._int_mm`` also exists.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import ir as jir, profiler as jprofiler
from mxnet_tpu.ops import quantized as jq
from mxnet_tpu.serving import AOTPredictor as JPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config, ir, profiler
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ir import CalibrationError
from mxnet_tpu_torch.ops import quantized as tq
from mxnet_tpu_torch.serving import AOTPredictor, ModelServer, ServingError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _trained_mlp():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from bench_serve import _train_model, build_model

    net, _ = build_model(64, 128, 3, 16)
    args_np, sample = _train_model(net, 64, 16, epochs=5, n=2048,
                                   batch=128)
    return net, tmx.sym.load_json(net.tojson()), args_np, sample


@pytest.fixture(scope="module")
def trained_mlp():
    return _trained_mlp()


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _port_pred(sym, args, **kw):
    return _quiet(AOTPredictor, sym, args, device="cpu", **kw)


def _jax_pred(sym, args, **kw):
    return _quiet(JPredictor, sym, args, **kw)


# ---------------------------------------------------------------------------
# the four ops
# ---------------------------------------------------------------------------
def test_int8_ops_registered_as_jax():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    for name in ("_quantize_int8", "_quantize_rows_int8",
                 "_int8_fully_connected", "_int8_convolution"):
        jop, top = jreg.get(name), treg.get(name)
        assert top.nondiff and jop.nondiff, name
        assert top.input_names == jop.input_names, name
        assert top.optional_inputs == jop.optional_inputs, name
        assert top.attr_defaults == jop.attr_defaults, name
        assert top.n_outputs({}) == jop.n_outputs({}), name


def _boundaries(scale):
    """Values at (k + 0.5) * scale for k in -130..129 and one float32 ulp
    either side."""
    base = ((np.arange(-130, 130) + 0.5) * scale).astype(np.float32)
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])


@pytest.mark.parametrize("scale", [0.0123456, 0.1, 1.0 / 127, 0.731])
def test_quantize_int8_bit_for_bit_at_round_boundaries(scale):
    rng = np.random.RandomState(int(scale * 1e4))
    x = np.concatenate([_boundaries(scale),
                        (rng.randn(4096) * 60 * scale).astype(np.float32)])
    want = np.asarray(jq._quantize_int8(jnp.asarray(x), scale=scale))
    got = tq._quantize_int8(torch.from_numpy(x), scale=scale)
    assert got.dtype == torch.float32          # the CPU's carrier
    assert np.array_equal(got.numpy(), want)
    assert got.abs().max() <= 127
    # round half to even, as jnp.round
    assert tq._quantize_int8(torch.tensor([0.5, 1.5, 2.5, -0.5]),
                             scale=1.0).tolist() == [0.0, 2.0, 2.0, -0.0]


@pytest.mark.parametrize("shape", [(6, 5), (8, 3, 3, 3), (7,), (4, 2, 1, 1)])
def test_quantize_rows_int8_bit_for_bit(shape):
    rng = np.random.RandomState(len(shape))
    w = (rng.randn(*shape) * 0.3).astype(np.float32)
    w[0] = 0.0                                 # a zero row: the scale floor
    jw, js = jq._quantize_rows_int8(jnp.asarray(w))
    tw, ts = tq._quantize_rows_int8(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def _int8_operands(rng, xshape, wshape):
    x = rng.randint(-127, 128, xshape).astype(np.float32)
    w = rng.randint(-127, 128, wshape).astype(np.int8)
    return x, w, rng.uniform(0.001, 0.01, wshape[0]).astype(np.float32), \
        rng.randn(wshape[0]).astype(np.float32)


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("no_bias", [False, True])
def test_int8_fully_connected_matches_jax(flatten, no_bias):
    rng = np.random.RandomState(2 * flatten + no_bias)
    x, w, ws, b = _int8_operands(rng, (5, 3, 12),
                                 (6, 36 if flatten else 12))
    kw = dict(num_hidden=6, no_bias=no_bias, flatten=flatten, scale=0.037)
    want = jq._int8_fully_connected(*map(jnp.asarray, (x, w, ws, b)), **kw)
    got = tq._int8_fully_connected(*map(torch.from_numpy, (x, w, ws, b)),
                                   **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


CONV_CASES = [  # (kernel, stride, pad, dilate, num_group, no_bias)
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, False),
    ((3, 3), (2, 2), (1, 1), (1, 1), 1, True),
    ((7, 7), (2, 2), (3, 3), (1, 1), 1, True),
    ((3, 3), (1, 2), (2, 1), (2, 2), 1, False),
    ((1, 1), (2, 2), (0, 0), (1, 1), 2, False),
    ((3, 3), (1, 1), (1, 1), (1, 1), 2, True),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(
    "x".join(map(str, v)) if isinstance(v, tuple) else str(v) for v in c))
def test_int8_convolution_matches_jax(case):
    kernel, stride, pad, dilate, group, no_bias = case
    rng = np.random.RandomState(sum(kernel) + 3 * group + stride[1])
    x, w, ws, b = _int8_operands(rng, (2, 4, 11, 10),
                                 (8, 4 // group) + kernel)
    kw = dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
              num_filter=8, num_group=group, no_bias=no_bias, scale=0.021)
    want = jq._int8_convolution(*map(jnp.asarray, (x, w, ws, b)), **kw)
    got = tq._int8_convolution(*map(torch.from_numpy, (x, w, ws, b)), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# the card's routes, run on the CPU (torch._int_mm exists there too):
# (n, c, h, w, o, k, stride, pad, dilate, group), ResNet-50's stem (K 147)
# and a batch-1 FC (M 1) among them
CARD_CONVS = [(1, 3, 29, 29, 64, 7, 2, 3, 1, 1), (2, 8, 9, 9, 16, 3, 1, 1, 1, 1),
              (2, 8, 9, 9, 16, 3, 2, 1, 2, 1), (3, 5, 6, 7, 10, 1, 1, 0, 1, 1),
              (2, 8, 9, 9, 8, 3, 1, 1, 1, 8), (2, 8, 9, 9, 16, 3, 2, 1, 1, 2)]
CARD_FCS = [(1, 2048, 1000), (3, 147, 10), (64, 256, 512)]


def _card_route_cases(device):
    """Each conv and FC case's exact accumulation on ``device`` through the
    card's code, beside float64 of the same int8 operands on the CPU."""
    rng = np.random.RandomState(5)
    out = []
    for (n, c, h, w, o, k, s, p, d, g) in CARD_CONVS:
        x = torch.from_numpy(rng.randint(-127, 128, (n, c, h, w))).to(
            torch.int8)
        wq = torch.from_numpy(rng.randint(-127, 128, (o, c // g, k, k))).to(
            torch.int8)
        acc = tq.int8_conv_acc(x.to(device), wq.to(device), (s, s), (p, p),
                               (d, d), g)
        out.append((acc.cpu(), F.conv2d(x.double(), wq.double(), stride=s,
                                        padding=p, dilation=d, groups=g)))
    for (m, k, o) in CARD_FCS:
        x = torch.from_numpy(rng.randint(-127, 128, (m, k))).to(torch.int8)
        wq = torch.from_numpy(rng.randint(-127, 128, (o, k))).to(torch.int8)
        out.append((tq.int8_linear_acc(x.to(device), wq.to(device)).cpu(),
                    x.double() @ wq.double().t()))
    return out


def test_card_routes_equal_float64_run_on_the_cpu(monkeypatch):
    """The card's code (padding to ``_int_mm``'s shape rules, the int8
    im2col, the grouped float32 route) on the CPU: int32 and exact
    accumulations equal float64 bit for bit, each route counted."""
    monkeypatch.setattr(tq, "_on_card", lambda t: True)
    monkeypatch.setattr(tq, "routes", {"int_mm": 0, "f32_exact": 0})
    for acc, want in _card_route_cases("cpu"):
        assert acc.shape == want.shape
        assert torch.equal(acc.double(), want)
    assert tq.routes == {"int_mm": 7, "f32_exact": 2}
    # past 2**24 the grouped float32 route is not exact: it raises
    x = torch.zeros((1, 2 * 130, 4, 4), dtype=torch.int8)
    w = torch.zeros((2, 130, 3, 3), dtype=torch.int8)
    with pytest.raises(MXNetError, match="exact up to 1040"):
        tq.int8_conv_acc(x, w, (1, 1), (1, 1), (1, 1), 2)
    # and the op on the card path returns an int8 tensor from
    # _quantize_int8
    assert tq._quantize_int8(torch.tensor([0.26]), scale=0.1).dtype == \
        torch.int8


@pytest.mark.cuda
def test_card_routes_equal_float64_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = dict(tq.routes)
    for acc, want in _card_route_cases("cuda"):
        assert acc.shape == want.shape
        assert torch.equal(acc.double(), want)
    assert tq.routes["int_mm"] - before["int_mm"] == 7
    assert tq.routes["f32_exact"] - before["f32_exact"] == 2
    x = _boundaries(0.0123456)
    on_card = tq._quantize_int8(torch.from_numpy(x).cuda(), scale=0.0123456)
    assert on_card.dtype == torch.int8
    assert torch.equal(on_card.cpu().float(),
                       tq._quantize_int8(torch.from_numpy(x),
                                         scale=0.0123456))


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------
def _conv_net(mx):
    d = mx.sym.var("data")
    c1 = mx.sym.Convolution(data=d, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="c1")
    r1 = mx.sym.Activation(data=c1, act_type="relu")
    c2 = mx.sym.Convolution(data=r1, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="c2")
    return mx.sym.FullyConnected(data=mx.sym.Flatten(data=c2), num_hidden=4,
                                 name="out")


def _conv_params(net, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(data=(2, 3, 8, 8))
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n != "data"}
    calib = [{"data": rng.randn(2, 3, 8, 8).astype(np.float32)}
             for _ in range(3)]
    return params, calib


def _ops(sym):
    return [(n.name, n.op.name) for n in sym._topo() if not n.is_variable()]


def test_conv_net_rewrites_as_jax():
    """``quantize_for_serving`` on the small conv net: the same rewritten
    graph (op list, node names, argument names), scales within rtol 1e-6,
    ``quantized_ops`` 3, the same ``pass_stats``; and the int8 forward
    tracks the JAX one and the float one."""
    with tname.NameManager():
        tnet = _conv_net(tmx)
    with jmx.name.NameManager():
        jnet = _conv_net(jmx)
    params, calib = _conv_params(jnet)
    profiler.pass_reset()
    jprofiler.pass_reset()
    tsym, trep = ir.quantize_for_serving(tnet, params, calib, ["data"],
                                        device="cpu")
    jsym, jrep = jir.quantize_for_serving(jnet, params, calib, ["data"])
    assert _ops(tsym) == _ops(jsym)
    assert [op for _, op in _ops(tsym)].count("_int8_convolution") == 2
    assert tsym.list_arguments() == jsym.list_arguments() == \
        tnet.list_arguments()
    assert trep["quantized_ops"] == jrep["quantized_ops"] == 3
    assert trep["calib_batches"] == jrep["calib_batches"] == 3
    for name, rec in jrep["calibration"].items():
        np.testing.assert_allclose(trep["calibration"][name]["scale"],
                                   rec["scale"], rtol=1e-6)
    tstats, jstats = profiler.pass_stats(), jprofiler.pass_stats()
    assert tstats["passes"]["quantize"] == {
        k: jstats["passes"]["quantize"][k] for k in tstats["passes"][
            "quantize"]}
    assert set(tstats["calibration"]) == set(jstats["calibration"])
    # the rewritten graph's JSON loads in the other package, node for node
    assert _ops(jmx.sym.load_json(tsym.tojson())) == _ops(jsym)
    assert _ops(tmx.sym.load_json(jsym.tojson())) == _ops(tsym)
    # its forward: against the JAX rewritten graph and the float one
    x = np.random.RandomState(9).randn(4, 3, 8, 8).astype(np.float32)
    kw = dict(data_shapes={"data": (1, 3, 8, 8)}, ladder=(4,))
    got = _port_pred(tsym, params, **kw).predict(x)[0]
    want = _jax_pred(jsym, params, **kw).predict(x)[0]
    np.testing.assert_allclose(got, want, **TOL)
    float_out = _port_pred(tnet, params, **kw).predict(x)[0]
    assert np.abs(float_out - got).max() / np.abs(float_out).max() < 0.05


def test_quantize_pass_names_its_calibration_context():
    with pytest.raises(ir.PassError, match="calibration context"):
        ir.apply_passes(_conv_net(tmx), ["quantize"])
    qsym, prov = ir.PASSES["quantize"](scales={"c2": 0.5}).apply(
        _conv_net(tmx))
    assert prov["quantized_ops"] == 1
    assert [op for _, op in _ops(qsym)].count("_int8_convolution") == 1


def test_unfused_resnet50_quantizes_as_many_ops_as_jax():
    """From the symbol alone: the same targets and the same rewrite count
    (53 convolutions and fc1) as the JAX pass, with a placeholder scale."""
    from mxnet_tpu.ir.quantize import _target_nodes as jtargets
    from mxnet_tpu.models import resnet as jresnet
    from mxnet_tpu_torch.ir.quantize import _target_nodes
    from mxnet_tpu_torch.models import resnet as tresnet

    kw = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
              fused=False)
    with tname.NameManager():
        tsym = tresnet.get_symbol(**kw)
    with jmx.name.NameManager():
        jsym = jresnet.get_symbol(**kw)
    names = [n.name for n, _ in _target_nodes(tsym)]
    assert names == [n.name for n, _ in jtargets(jsym)]
    scales = {n: 1.0 for n in names}
    tq_sym, tprov = ir.QuantizePass(scales).apply(tsym)
    jq_sym, jprov = jir.QuantizePass(scales).apply(jsym)
    assert tprov["quantized_ops"] == jprov["quantized_ops"] == 54
    assert _ops(tq_sym) == _ops(jq_sym)


def test_quantize_skips_computed_bias_and_1d_convs():
    """As the reference's two cases: an FC with a computed bias is neither
    calibrated nor rewritten; a 1-D conv stays float."""
    d = tmx.sym.var("data")
    b0 = tmx.sym.var("b0", shape=(2,))
    fc = tmx.sym.FullyConnected(data=d, num_hidden=2, bias=b0 * 2.0,
                                name="fcb")
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = fc.infer_shape(data=(2, 4))
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(fc.list_arguments(), arg_shapes) if n != "data"}
    qsym, report = ir.quantize_for_serving(
        fc, params, [{"data": rng.randn(2, 4).astype(np.float32)}], ["data"],
        device="cpu")
    assert report["quantized_ops"] == 0 and not report["calibration"]
    assert "_int8_fully_connected" not in [op for _, op in _ops(qsym)]

    c = tmx.sym.Convolution(data=d, num_filter=4, kernel=(3,), pad=(1,),
                            name="c1d")
    net = tmx.sym.FullyConnected(data=tmx.sym.Flatten(data=c), num_hidden=2,
                                 name="out")
    arg_shapes, _, _ = net.infer_shape(data=(2, 3, 8))
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n != "data"}
    qsym, report = ir.quantize_for_serving(
        net, params, [{"data": rng.randn(2, 3, 8).astype(np.float32)}],
        ["data"], device="cpu")
    ops = [op for _, op in _ops(qsym)]
    assert ops.count("Convolution") == 1 and report["quantized_ops"] == 1
    assert ops.count("_int8_fully_connected") == 1


# ---------------------------------------------------------------------------
# the predictor and the server
# ---------------------------------------------------------------------------
def test_int8_predictor_matches_jax_on_the_trained_mlp(trained_mlp):
    """The reference's acceptance scenario on the port: 4 quantized ops,
    logits and top-1 as the JAX int8 predictor's, top-1 agreement with
    bf16 >= 0.99; a swap requantizes the weights."""
    jnet, tnet, args_np, sample = trained_mlp
    calib = [{"data": sample(64, 500 + i)[0]} for i in range(4)]
    corpus, _labels = sample(1024, 900)
    kw = dict(data_shapes={"data": (1, 64)}, ladder=(1024,))
    pb = _port_pred(tnet, args_np, dtype="bfloat16", **kw)
    pq = _port_pred(tnet, args_np, quant="int8", calib_data=calib, **kw)
    jpq = _jax_pred(jnet, args_np, quant="int8", calib_data=calib, **kw)
    assert pq.bind_stats["quant"] == "int8"
    assert pq.bind_stats["quantized_ops"] == jpq.bind_stats[
        "quantized_ops"] == 4
    assert pq.bind_stats["folded_nodes"] == jpq.bind_stats["folded_nodes"]
    want_scales = jpq.quant_report["calibration"]
    assert set(pq.quant_report["calibration"]) == set(want_scales)
    for name, rec in pq.quant_report["calibration"].items():
        np.testing.assert_allclose(rec["scale"], want_scales[name]["scale"],
                                   rtol=1e-6)
    got, want = pq.predict(corpus)[0], jpq.predict(corpus)[0]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.array_equal(got.argmax(1), want.argmax(1))
    top_b = pb.predict(corpus)[0].argmax(1)
    assert float((got.argmax(1) == top_b).mean()) >= 0.99

    swapped = {k: v + 0.01 * np.abs(v).max()
               * np.random.RandomState(3).randn(*v.shape).astype(np.float32)
               for k, v in args_np.items()}
    assert pq.swap_params(swapped) == len(args_np)
    fresh = _port_pred(tnet, swapped, quant="int8", calib_data=calib, **kw)
    after = pq.predict(corpus)[0]
    # the weights requantized; the activation scales stay calibrated
    assert not np.array_equal(after, got)
    pb2 = _port_pred(tnet, swapped, dtype="bfloat16", **kw)
    assert float((after.argmax(1) == pb2.predict(corpus)[0].argmax(1))
                 .mean()) >= 0.99
    assert np.abs(after - fresh.predict(corpus)[0]).max() <= \
        0.05 * np.abs(after).max()


def test_int8_requires_calibration_and_a_known_mode(trained_mlp):
    _jnet, tnet, args_np, _sample = trained_mlp
    kw = dict(data_shapes={"data": (1, 64)})
    with pytest.raises(CalibrationError, match="got None"):
        _port_pred(tnet, args_np, quant="int8", **kw)
    with pytest.raises(CalibrationError, match="empty"):
        _port_pred(tnet, args_np, quant="int8", calib_data=[], **kw)
    with pytest.raises(CalibrationError, match="missing model inputs"):
        _port_pred(tnet, args_np, quant="int8", calib_data=[{"x": 1}], **kw)
    with pytest.raises(ServingError, match="quant"):
        _port_pred(tnet, args_np, quant="float7", **kw)
    assert _port_pred(tnet, args_np, quant=" NONE ", **kw).bind_stats[
        "quant"] == "none"


def test_quant_knobs_validated_as_jax(trained_mlp, monkeypatch):
    _jnet, tnet, args_np, sample = trained_mlp
    assert config.KNOBS["MXNET_SERVE_QUANT"][0] == "none"
    assert config.KNOBS["MXNET_QUANT_CALIB_BATCHES"][0] == "8"
    kw = dict(data_shapes={"data": (1, 64)}, ladder=(16,))
    monkeypatch.setenv("MXNET_SERVE_QUANT", "int7")
    with pytest.raises(MXNetError, match="MXNET_SERVE_QUANT"):
        _port_pred(tnet, args_np, **kw)
    calib = [{"data": sample(16, 600 + i)[0]} for i in range(5)]
    monkeypatch.setenv("MXNET_SERVE_QUANT", "int8")
    pred = _port_pred(tnet, args_np, calib_data=calib, **kw)
    assert pred.bind_stats["quant"] == "int8"
    assert pred.quant_report["calib_batches"] == 5
    monkeypatch.setenv("MXNET_QUANT_CALIB_BATCHES", "2")
    assert _port_pred(tnet, args_np, calib_data=calib, **kw).quant_report[
        "calib_batches"] == 2
    monkeypatch.setenv("MXNET_QUANT_CALIB_BATCHES", "-3")
    with pytest.raises(MXNetError, match="MXNET_QUANT_CALIB_BATCHES"):
        _port_pred(tnet, args_np, calib_data=calib[:1], **kw)


def test_model_server_int8_swap_from_checkpoint(trained_mlp, tmp_path):
    """``add_model(quant="int8", calib_data=)`` serves; after a swap to
    perturbed weights, ``swap_from_checkpoint`` of the port's checkpoint of
    the trained ones serves exactly what a fresh int8 bind of them does,
    and so does its ``directory=`` form from a ``CheckpointManager``
    directory (an empty one raises)."""
    from mxnet_tpu_torch.model import save_checkpoint

    _jnet, tnet, args_np, sample = trained_mlp
    calib = [{"data": sample(64, 700 + i)[0]} for i in range(2)]
    x = sample(24, 901)[0]
    prefix = str(tmp_path / "mlp")
    save_checkpoint(prefix, 3, tnet,
                    {k: tmx.nd.array(v, ctx=tmx.cpu())
                     for k, v in args_np.items()}, {})
    moved = {k: (v * 0.9).astype(np.float32) for k, v in args_np.items()}
    kw = dict(data_shapes={"data": (1, 64)}, quant="int8", calib_data=calib)
    with ModelServer(ladder=(4, 32), device="cpu") as srv:
        pred = _quiet(srv.add_model, "mlp", symbol=tnet, arg_params=args_np,
                      **kw)
        assert pred.bind_stats["quantized_ops"] == 4
        srv.swap("mlp", moved)
        perturbed = srv.predict("mlp", x)[0]
        assert srv.swap_from_checkpoint("mlp", prefix=prefix,
                                        epoch=3) == len(args_np)
        restored = srv.predict("mlp", x)[0]
        with pytest.raises(ServingError, match="no committed checkpoint"):
            srv.swap_from_checkpoint("mlp", directory=str(tmp_path / "ck"))
        from mxnet_tpu_torch.checkpoint import CheckpointManager

        CheckpointManager(str(tmp_path / "ck")).save(
            3, weights={"arg:%s" % k: v for k, v in args_np.items()})
        srv.swap("mlp", moved)
        assert srv.swap_from_checkpoint(
            "mlp", directory=str(tmp_path / "ck")) == len(args_np)
        np.testing.assert_array_equal(srv.predict("mlp", x)[0], restored)
        with pytest.raises(ServingError, match="exactly one"):
            srv.swap_from_checkpoint("mlp")
    fresh = _port_pred(tnet, args_np, ladder=(4, 32), **kw)
    np.testing.assert_array_equal(restored, fresh.predict(x)[0])
    assert not np.array_equal(perturbed, restored)
