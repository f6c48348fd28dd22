"""Fused ResNet image serving of the PyTorch port against the JAX package,
on the tiny net of ``tests/test_fused_resnet.py`` (2 + 1 bottleneck units,
widths 8/16/32, 64x64 images, 5 classes), everything on the CPU.

- The fusion pass: 3 ``FusedBottleneckUnit`` and exactly 2 ``transpose``
  in both packages, the same argument and auxiliary-state names and the
  same inferred shapes; Symbol JSON round-trips within the port and
  across the two packages; ``apply_passes`` refuses a pass that changes
  the output shapes.
- The ``MXNET_SERVE_BATCH_LADDER`` knob reads as the JAX package reads it,
  well-formed or not.
- Serving: ``fc1_output`` of the port's ``AOTPredictor`` (fused graph, B1's
  plain version) against the JAX ``AOTPredictor`` (fused graph, the Pallas
  kernels in interpret mode) and against the port's own unfused graph,
  within 1e-4 of the largest logit, from one seeded numpy weight set
  (``models.resnet.init_params``, perturbed so every BN folds to a
  nontrivial scale and bias) carried across by ``params_from_jax``.
- ``ModelServer``: concurrent mixed-size requests coalesce into buckets
  and each gets the rows ``predict`` gives alone; ``swap`` changes the
  answers; ``quant="int8"`` quantizes the stem and the classifier (the
  fused units are not quantizable, as in the JAX pass); ``mesh`` raises;
  the training unit runs; the default device is ``cuda``.

The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX
calls ``pltpu.CompilerParams``; each test sets that alias with
``monkeypatch`` and undoes it afterwards.
"""
import threading

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.serving import AOTPredictor as JaxAOTPredictor
from mxnet_tpu_torch import ir
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_block as tfb
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.serving import AOTPredictor, ModelServer, ServingError

TINY = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
SHAPE = (2, 3, 64, 64)
LOGIT_TOL = 1e-4      # of the largest |logit|


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    """The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this
    JAX calls ``pltpu.CompilerParams`` (shape inference of the JAX fused
    graph traces them too)."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _tiny(mod, fused):
    return mod.resnet(fused=fused, **TINY)


def _op_counts(symbol):
    ops = [n.op.name for n in symbol._topo() if not n.is_variable()]
    return {k: ops.count(k) for k in set(ops)}


@pytest.fixture(scope="module")
def graphs():
    return {"port_fused": _tiny(tresnet, True),
            "port_unfused": _tiny(tresnet, False),
            "jax_fused": _tiny(jresnet, True)}


@pytest.fixture(scope="module")
def params(graphs):
    """Seeded weights, with BN scales, shifts and moving statistics moved
    off their identity values so the prologue's folding is exercised."""
    args, auxs = tresnet.init_params(graphs["port_fused"], SHAPE, seed=0)
    rng = np.random.RandomState(1)
    for name, v in args.items():
        if name.endswith("_gamma"):
            args[name] = (v * rng.uniform(0.8, 1.2, v.shape)).astype(
                np.float32)
        elif name.endswith("_beta"):
            args[name] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    for name, v in auxs.items():
        auxs[name] = (rng.uniform(0.6, 1.6, v.shape) if name.endswith("_var")
                      else rng.normal(0, 0.2, v.shape)).astype(np.float32)
    return args, auxs


def _images(seed, n):
    return np.random.RandomState(seed).randn(n, *SHAPE[1:]).astype(
        np.float32)


def test_fusion_pass_matches_jax(graphs):
    tf, jf = graphs["port_fused"], graphs["jax_fused"]
    for counts in (_op_counts(tf), _op_counts(jf)):
        assert counts["FusedBottleneckUnit"] == 3
        assert counts["transpose"] == 2
        assert "Convolution" in counts   # the stem stays a library conv
    assert _op_counts(tf) == _op_counts(jf)
    assert tf.list_arguments() == jf.list_arguments()
    assert tf.list_auxiliary_states() == jf.list_auxiliary_states()
    for got, want in zip(tf.infer_shape(data=SHAPE),
                         jf.infer_shape(data=SHAPE)):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_fused_and_unfused_share_parameters(graphs):
    tf, tu = graphs["port_fused"], graphs["port_unfused"]
    assert sorted(tf.list_arguments()) == sorted(tu.list_arguments())
    assert sorted(tf.list_auxiliary_states()) == \
        sorted(tu.list_auxiliary_states())
    a_f, _, x_f = tf.infer_shape(data=SHAPE)
    a_u, _, x_u = tu.infer_shape(data=SHAPE)
    assert dict(zip(tf.list_arguments(), a_f)) == \
        dict(zip(tu.list_arguments(), a_u))
    assert dict(zip(tf.list_auxiliary_states(), x_f)) == \
        dict(zip(tu.list_auxiliary_states(), x_u))


def test_json_round_trips(graphs):
    from mxnet_tpu import symbol as jsym

    tf, jf = graphs["port_fused"], graphs["jax_fused"]
    text = tf.tojson()
    assert tsym.load_json(text).tojson() == text
    # across the packages: the same graph, node for node
    for loaded, ref in ((tsym.load_json(jf.tojson()), jf),
                        (jsym.load_json(text), tf)):
        assert loaded.list_arguments() == ref.list_arguments()
        assert loaded.list_auxiliary_states() == ref.list_auxiliary_states()
        assert _op_counts(loaded) == _op_counts(ref)


def test_fusion_pass_is_a_pass(graphs):
    """The port's builder output equals apply_passes over the unfused
    graph, and the kill switch returns the unfused graph."""
    again = ir.apply_passes(graphs["port_unfused"], passes="fusion",
                            data_shapes={"data": SHAPE})
    assert _op_counts(again) == _op_counts(graphs["port_fused"])
    # the quantize pass needs its calibration context; given scales, it
    # rewrites the fused graph's stem conv and classifier only, as the
    # JAX pass does (FusedBottleneckUnit is not a quantizable op)
    with pytest.raises(ir.PassError, match="calibration context"):
        ir.apply_passes(graphs["port_unfused"], passes="quantize")
    from mxnet_tpu.ir.quantize import _target_nodes as jax_targets
    from mxnet_tpu_torch.ir.quantize import _target_nodes

    names = [n.name for n, _ in _target_nodes(graphs["port_fused"])]
    assert names == [n.name for n, _ in
                     jax_targets(graphs["jax_fused"])] == ["conv0", "fc1"]
    qsym, prov = ir.PASSES["quantize"](
        scales=dict.fromkeys(names, 1.0)).apply(graphs["port_fused"])
    assert prov["quantized_ops"] == 2
    assert _op_counts(qsym)["FusedBottleneckUnit"] == 3


def test_apply_passes_guards_output_shapes(graphs, monkeypatch):
    """With data_shapes, a pass that changes the output shapes raises."""
    unfused = graphs["port_unfused"]
    internals = unfused.get_internals()
    pooled = internals[internals.list_outputs().index("pool1_output")]

    class ToPool:
        def apply(self, symbol):
            return pooled, {"pass": "fusion"}

    monkeypatch.setitem(ir.PASSES, "fusion", ToPool)
    with pytest.raises(ir.PassError, match="output shapes"):
        ir.apply_passes(unfused, passes="fusion",
                        data_shapes={"data": SHAPE})
    assert ir.apply_passes(unfused, passes="fusion") is pooled


@pytest.mark.parametrize("raw", [None, "", "1,2,8", " 4, 16 ", "1,x", "4,2",
                                 "0,1"])
def test_batch_ladder_knob_matches_jax(monkeypatch, raw):
    from mxnet_tpu.serving import env_batch_ladder as jax_ladder
    from mxnet_tpu_torch.serving.predictor import env_batch_ladder

    if raw is None:
        monkeypatch.delenv("MXNET_SERVE_BATCH_LADDER", raising=False)
    else:
        monkeypatch.setenv("MXNET_SERVE_BATCH_LADDER", raw)
    try:
        want = jax_ladder()
    except Exception as e:   # the JAX package's ServingError
        with pytest.raises(ServingError, match="MXNET_SERVE_BATCH_LADDER"):
            env_batch_ladder()
        assert "MXNET_SERVE_BATCH_LADDER" in str(e)
    else:
        assert env_batch_ladder() == want


def test_fuse_kill_switch(monkeypatch):
    monkeypatch.setenv("MXNET_IR_FUSE", "0")
    assert "FusedBottleneckUnit" not in _op_counts(_tiny(tresnet, True))
    monkeypatch.setenv("MXNET_IR_FUSE", "maybe")
    with pytest.raises(MXNetError, match="MXNET_IR_FUSE"):
        _tiny(tresnet, True)


def _port_logits(symbol, args, auxs, x):
    a, b = tresnet.params_from_jax(args, auxs, symbol, device="cpu",
                                   data_shape=SHAPE)
    pred = AOTPredictor(symbol, a, b, data_shapes={"data": SHAPE},
                        ladder=(SHAPE[0],), device="cpu",
                        output_names=["fc1_output"])
    return pred.predict(x)[0]


def test_logits_match_jax_predictor(graphs, params):
    args, auxs = params
    x = _images(2, SHAPE[0])
    jpred = JaxAOTPredictor(graphs["jax_fused"], args, auxs,
                            data_shapes={"data": SHAPE}, ladder=(SHAPE[0],),
                            output_names=["fc1_output"])
    want = np.asarray(jpred.predict(x)[0])
    fused = _port_logits(graphs["port_fused"], args, auxs, x)
    unfused = _port_logits(graphs["port_unfused"], args, auxs, x)
    scale = np.abs(want).max()
    assert fused.shape == want.shape == (SHAPE[0], TINY["num_classes"])
    assert 0.1 < scale < 100          # logits neither vanish nor saturate
    assert np.abs(fused - want).max() <= LOGIT_TOL * scale
    assert np.abs(unfused - want).max() <= LOGIT_TOL * scale


def test_label_is_zero_filled_and_softmax_served(graphs, params):
    args, auxs = params
    with pytest.warns(UserWarning, match="softmax_label"):
        pred = AOTPredictor(graphs["port_fused"], args, auxs,
                            data_shapes={"data": SHAPE}, ladder=(1, 2),
                            device="cpu")
    assert pred.bind_stats["zero_filled"] == ["softmax_label"]
    assert pred.output_names == ["softmax_output"]
    probs = pred.predict(_images(4, 1))[0]
    assert probs.shape == (1, TINY["num_classes"])
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_params_from_jax_checks_names_and_shapes(graphs, params):
    args, auxs = params
    bad = dict(args, fc1_weight=np.zeros((3, 3), np.float32))
    with pytest.raises(MXNetError, match="fc1_weight"):
        tresnet.params_from_jax(bad, auxs, graphs["port_fused"], "cpu",
                                data_shape=SHAPE)
    with pytest.raises(MXNetError, match="nope"):
        tresnet.params_from_jax(dict(args, nope=np.zeros(1)), auxs,
                                graphs["port_fused"], "cpu",
                                data_shape=SHAPE)


@pytest.fixture
def server(graphs, params):
    tprofiler.serving_reset()
    args, auxs = params
    srv = ModelServer(ladder=(1, 2, 4, 8), device="cpu")
    srv.add_model("resnet", symbol=graphs["port_fused"], arg_params=args,
                  aux_params=auxs, data_shapes={"data": (1,) + SHAPE[1:]},
                  output_names=["fc1_output"])
    yield srv
    srv.close()
    tprofiler.serving_reset()


def test_model_server_coalesces_concurrent_requests(server):
    sizes = [1, 3, 2, 1, 2, 1, 3, 2, 1]
    images = [_images(10 + i, n) for i, n in enumerate(sizes)]
    worker = server._worker("resnet")
    futures = [None] * len(sizes)

    def client(idx):
        for i in idx:
            futures[i] = server.submit("resnet", images[i])

    # hold the worker inside its first batch so the rest queue up behind it
    with worker._exec_lock:
        futures[0] = server.submit("resnet", images[0])
        threads = [threading.Thread(target=client, args=(range(s, 9, 3),))
                   for s in (1, 2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    got = [f.result(timeout=60)[0] for f in futures]
    pred = worker.predictor
    for img, out in zip(images, got):
        assert out.shape == (img.shape[0], TINY["num_classes"])
        np.testing.assert_allclose(out, pred.predict(img)[0], rtol=1e-5,
                                   atol=1e-5)
    stats = server.stats()["resnet"]
    assert stats["requests"] == len(sizes)
    assert stats["rows"] == sum(sizes)
    assert stats["batches"] < len(sizes)       # coalesced
    assert stats["errors"] == stats["shed"] == 0


def test_model_server_swap_changes_outputs(server, params):
    args, _auxs = params
    x = _images(20, 2)
    before = server.predict("resnet", x)[0]
    new_w = np.random.RandomState(3).randn(*args["fc1_weight"].shape)
    assert server.swap("resnet", {"fc1_weight": new_w.astype(np.float32)}) == 1
    after = server.predict("resnet", x)[0]
    assert np.abs(after - before).max() > 1e-3
    with pytest.raises(ServingError, match="not a frozen parameter"):
        server.swap("resnet", {"nope": new_w})


def test_unported_modes_raise(graphs, params):
    args, auxs = params
    sym = graphs["port_fused"]
    kw = dict(data_shapes={"data": SHAPE}, device="cpu")
    # int8 is ported: on the fused graph it quantizes the stem conv and the
    # classifier only, as the JAX pass does, and serves close to float
    x = _images(4, 2)
    pq = AOTPredictor(sym, args, auxs, quant="int8",
                      calib_data=[{"data": _images(5, 2)}], **kw)
    assert pq.bind_stats["quantized_ops"] == 2
    assert sorted(pq.quant_report["calibration"]) == ["conv0", "fc1"]
    want = AOTPredictor(sym, args, auxs, **kw).predict(x)[0]
    assert np.abs(pq.predict(x)[0] - want).max() < 0.05
    # the sharded bind is ported, but not int8 on it
    with pytest.raises(ServingError, match="not ported"):
        AOTPredictor(sym, args, auxs, mesh=object(), quant="int8",
                     data_shapes={"data": SHAPE})
    # the training unit is ported: it runs, and mixes its moving statistics
    # with the batch's without holding a graph
    fused = tsym.FusedBottleneckUnit(data=tsym.var("x"), num_filter=16,
                                     stride=1, dim_match=True)
    op = fused._entries[0][0].op
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    weights = [torch.full(s, 0.1, requires_grad=True)
               for s in ((4, 16, 1, 1), (4, 4, 3, 3), (16, 4, 1, 1))]
    bn = [torch.ones(c) for c in (16, 16, 4, 4, 4, 4)]
    moving = [torch.zeros(c) if i % 2 == 0 else torch.ones(c)
              for i, c in enumerate((16, 16, 4, 4, 4, 4))]
    out = op.fn(x, *weights, *bn, *moving, num_filter=16, momentum=0.5,
                __is_train__=True)
    assert len(out) == 7 and out[0].shape == x.shape
    assert torch.allclose(out[1], 0.5 * x.mean(dim=(0, 1, 2)), atol=1e-6)
    assert all(not m.requires_grad for m in out[1:])


def test_default_device_is_cuda(graphs, params):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    args, auxs = params
    with pytest.raises(MXNetError, match="device='cpu'"):
        AOTPredictor(graphs["port_fused"], args, auxs,
                     data_shapes={"data": SHAPE})
    with pytest.raises(MXNetError, match="device='cpu'"):
        ModelServer().add_model("m", symbol=graphs["port_fused"],
                                arg_params=args, aux_params=auxs,
                                data_shapes={"data": SHAPE})
    # int8 calibration runs its forward on the card too
    calib = [{"data": np.zeros(SHAPE, np.float32)}]
    with pytest.raises(MXNetError, match="device='cpu'"):
        ir.quantize_for_serving(graphs["port_fused"], {**args, **auxs},
                                calib, ["data"])
    with pytest.raises(MXNetError, match="device='cpu'"):
        AOTPredictor(graphs["port_fused"], args, auxs, quant="int8",
                     calib_data=calib, data_shapes={"data": SHAPE})
