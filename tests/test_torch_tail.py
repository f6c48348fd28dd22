"""The small modules of the single-process tail of the PyTorch port against
the JAX package's, on the CPU.

- ``viz.print_summary``: the text, character for character, and the total
  of the JAX package's, for the MLP of ``tests/test_parity_modules.py``
  and for ResNet-50 at full width (1000 classes, 224x224; unfused and
  fused), where only shape inference runs; ``plot_network``'s
  ``graphviz`` source equal where ``graphviz`` imports.
- ``contrib.tensorboard``: the records of ``_MiniEventWriter`` byte for
  byte the JAX package's for the same tags, steps and values, the wall
  time aside; the scenarios of ``tests/test_contrib_tensorboard.py`` in the
  port.
- ``executor_manager``: ``_split_input_slice``, ``_check_arguments``, the
  loaders and ``DataParallelExecutorManager`` on one context (gradients
  equal to the JAX package's, rtol 1e-4, atol 1e-5); a list of more than
  one context raises by name.
- ``log``'s format and levels, ``libinfo``'s keys, ``util`` and the
  ``test_utils`` functions against the JAX ones.
- ``rtc`` without a card: its signature parser, its missing-kernel error
  and its refusal by name (a machine with no CUDA device, a CPU context).
  The card's compile and launch are ``tests/test_torch_kernels_cuda.py``'s.
"""
import glob
import io
import logging
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.contrib import tensorboard as jtb
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import tensorboard as ttb

PKG = {"jax": jmx, "port": tmx}
RTOL, ATOL = 1e-4, 1e-5
RESNET50 = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------
def _summary_mlp(mx):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(data=net, act_type="relu", name="relu1")
    return mx.sym.FullyConnected(data=net, num_hidden=4, name="fc2")


def _resnet50(fused):
    def build(mx):
        from importlib import import_module

        resnet = import_module(mx.__name__ + ".models.resnet")
        return resnet.get_symbol(fused=fused, **RESNET50)
    return build


@pytest.mark.parametrize("build,shape", [
    (_summary_mlp, (2, 16)), (_resnet50(False), (1, 3, 224, 224)),
    (_resnet50(True), (1, 3, 224, 224))],
    ids=["mlp", "resnet50", "resnet50-fused"])
def test_print_summary_text_equals_jax(build, shape, capsys):
    got = {}
    for key, mx in PKG.items():
        with mx.name.NameManager():     # automatic names from 0 in both
            sym = build(mx)
        total = mx.viz.print_summary(sym, shape={"data": shape})
        got[key] = (total, capsys.readouterr().out)
        assert mx.visualization is mx.viz
    assert got["port"] == got["jax"]
    total, text = got["port"]
    if build is _summary_mlp:
        assert total == (16 * 8 + 8) + (8 * 4 + 4)
        assert "fc1 (FullyConnected)" in text
    else:
        # every argument but the data and the label is a parameter
        sym = build(tmx)
        arg_shapes, _, _ = sym.infer_shape(data=shape)
        want = sum(int(np.prod(s)) for n, s in zip(sym.list_arguments(),
                                                   arg_shapes)
                   if n not in ("data", "softmax_label"))
        assert total == want and 25.5e6 < total < 25.6e6
        assert text.splitlines()[-2] == "Total params: %d" % total


def test_plot_network_source_equals_jax():
    pytest.importorskip("graphviz")
    got = {}
    for key, mx in PKG.items():
        with mx.name.NameManager():
            dot = mx.viz.plot_network(_summary_mlp(mx), title="net",
                                      hide_weights=False)
        got[key] = dot.source
        got[key + "_hidden"] = mx.viz.plot_network(
            _summary_mlp(mx), node_attrs={"fontsize": "10"}).source
    assert got["port"] == got["jax"]
    assert got["port_hidden"] == got["jax_hidden"]
    assert "fc1" in got["port"] and "fc1_weight" not in got["port_hidden"]


def test_plot_network_without_graphviz_raises_by_name(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_graphviz(name, *a, **kw):
        if name == "graphviz":
            raise ImportError("no graphviz")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_graphviz)
    with pytest.raises(MXNetError, match="graphviz"):
        tmx.viz.plot_network(_summary_mlp(tmx))


# ---------------------------------------------------------------------------
# contrib.tensorboard
# ---------------------------------------------------------------------------
def _read_records(path):
    with open(path, "rb") as f:
        data = f.read()
    recs, off = [], 0
    while off < len(data):
        (ln,) = struct.unpack("<Q", data[off:off + 8])
        off += 12
        recs.append(data[off:off + ln])
        off += ln + 4
    return recs, data


def _without_wall_time(rec):
    # every event starts with field 1 (wall_time, a fixed64 double)
    assert rec[:1] == b"\x09"
    return rec[9:]


def test_event_records_equal_jax_byte_for_byte(tmp_path):
    scalars = [("train-accuracy", 0.5, 1), ("train-ce", 2.302585, 2),
               ("neg_step", 1.0, -1), ("big", 3.0e38, 2 ** 40)]
    got = {}
    for key, tb in (("jax", jtb), ("port", ttb)):
        w = tb._MiniEventWriter(str(tmp_path / key))
        for tag, v, step in scalars:
            w.add_scalar(tag, v, global_step=step)
        w.flush()
        w.close()
        (path,) = glob.glob(str(tmp_path / key / "events.out.tfevents.*"))
        recs, raw = _read_records(path)
        got[key] = [_without_wall_time(r) for r in recs]
        # the framing: a length, its masked crc32c, the payload, its crc
        off = 0
        for r in recs:
            head = raw[off:off + 8]
            assert struct.unpack("<I", raw[off + 8:off + 12])[0] == \
                ttb._masked_crc32c(head)
            assert struct.unpack("<I", raw[off + 12 + len(r):
                                          off + 16 + len(r)])[0] == \
                ttb._masked_crc32c(r)
            off += 16 + len(r)
    assert len(got["port"]) == 1 + len(scalars)
    assert got["port"] == got["jax"]
    for data in (b"", b"123456789", bytes(range(256))):
        assert ttb._crc32c(data) == jtb._crc32c(data)
        assert ttb._masked_crc32c(data) == jtb._masked_crc32c(data)
    assert ttb._crc32c(b"123456789") == 0xE3069283   # the CRC-32C check
    for n in (0, 1, 127, 128, 300, 2 ** 63 - 1, -1):
        assert ttb._varint(n) == jtb._varint(n)
    assert ttb._scalar_event("t", 0.25, 7, 1.5) == \
        jtb._scalar_event("t", 0.25, 7, 1.5)


def test_log_metrics_callback(tmp_path, monkeypatch):
    """``tests/test_contrib_tensorboard.py``'s callback scenario, on the
    port's own writer (``_make_writer`` takes torch's or tensorboardX's
    SummaryWriter where one imports)."""
    monkeypatch.setattr(ttb, "_make_writer",
                        lambda logdir: ttb._MiniEventWriter(logdir))
    cb = tmx.contrib.tensorboard.LogMetricsCallback(str(tmp_path),
                                                    prefix="train")
    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array([1.0, 0.0])],
                  [tmx.nd.array([[0.1, 0.9], [0.2, 0.8]])])

    class Param:
        eval_metric = metric

    for _ in range(3):
        cb(Param())
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    recs, _ = _read_records(path)
    assert sum(b"train-accuracy" in r for r in recs) == 3
    want = [_without_wall_time(jtb._scalar_event("train-accuracy", 0.5, s,
                                                 0.0)) for s in (1, 2, 3)]
    assert [_without_wall_time(r) for r in recs[1:]] == want

    class NoMetric:
        eval_metric = None

    cb(NoMetric())
    assert cb.step == 3


def test_contrib_namespaces():
    assert tmx.contrib.ndarray is tmx.nd.contrib
    assert tmx.contrib.symbol is tmx.sym.contrib
    out = tmx.contrib.ndarray.MultiBoxPrior(
        tmx.nd.ones((1, 3, 4, 4)), sizes=(0.5,), ratios=(1.0,))
    assert np.isfinite(out.asnumpy()).all()


def test_mini_event_writer_direct(tmp_path, monkeypatch):
    monkeypatch.setattr(ttb, "_make_writer",
                        lambda logdir: ttb._MiniEventWriter(logdir))
    cb = ttb.LogMetricsCallback(str(tmp_path), prefix="eval")
    metric = tmx.metric.MSE()
    metric.update([tmx.nd.array([1.0])], [tmx.nd.array([1.5])])

    class Param:
        eval_metric = metric

    cb(Param())
    cb.summary_writer.add_scalar("neg_step", 1.0, global_step=-1)
    cb.summary_writer.flush()
    files = glob.glob(str(tmp_path / "events.out.tfevents.*.mxtpu"))
    assert len(files) == 1
    recs, _ = _read_records(files[0])
    assert sum(b"eval-mse" in r for r in recs) == 1
    assert any(b"neg_step" in r for r in recs)
    ttb._MiniEventWriter(str(tmp_path))
    ttb._MiniEventWriter(str(tmp_path))
    assert len(glob.glob(str(tmp_path / "events.out.tfevents.*.mxtpu"))) == 3


# ---------------------------------------------------------------------------
# executor_manager
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,work", [(10, [1, 1, 2]), (7, [1]),
                                        (9, [3, 1]), (4, [1, 1, 1, 1])])
def test_split_input_slice_matches_jax(batch, work):
    got = tmx.executor_manager._split_input_slice(batch, work)
    assert got == jmx.executor_manager._split_input_slice(batch, work)
    assert got[0].start == 0 and got[-1].stop == batch
    for mgr in (tmx.executor_manager, jmx.executor_manager):
        with pytest.raises(Exception, match="smaller than the device"):
            mgr._split_input_slice(2, [1, 1, 1])


def _mgr_net(mx):
    h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=6, name="fc1")
    h = mx.sym.FullyConnected(mx.sym.Activation(h, act_type="relu"),
                              num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def test_executor_manager_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    w = {"fc1_weight": rng.randn(6, 5), "fc1_bias": rng.randn(6),
         "fc2_weight": rng.randn(3, 6), "fc2_bias": rng.randn(3)}
    got = {}
    for key, mx in PKG.items():
        net = _mgr_net(mx)
        mx.executor_manager._check_arguments(net)
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        mgr = mx.executor_manager.DataParallelExecutorManager(
            net, mx.cpu(), it)
        assert mgr.param_names == ["fc1_weight", "fc1_bias", "fc2_weight",
                                   "fc2_bias"]
        mgr.set_params({k: mx.nd.array(v.astype(np.float32))
                        for k, v in w.items()}, {})
        mon = mx.mon.Monitor(1, pattern="fc2_weight")
        mgr.install_monitor(mon)
        mon.tic()
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        metric = mx.metric.Accuracy()
        mgr.update_metric(metric, [mx.nd.array(y)])
        got[key] = ([g[0].asnumpy() for g in mgr.grad_arrays],
                    metric.get()[1], [k for _, k, _ in mon.toc()])
        dst = [mx.nd.zeros((2, 5)), mx.nd.zeros((2, 5))]
        mx.executor_manager._load_general([mx.nd.array(x[:4])], [dst],
                                          [slice(0, 2), slice(2, 4)])
        np.testing.assert_array_equal(dst[1].asnumpy(), x[2:4])
    for j, t in zip(got["jax"][0], got["port"][0]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert got["port"][1:] == got["jax"][1:]


def test_executor_manager_refuses_context_lists_by_name():
    """A context list, refused before, binds one executor a context, each
    at its slice of the batch, as the JAX manager does; duplicate argument
    names are still refused."""
    sizes = {}
    for pkg in (tmx, jmx):
        it = pkg.io.NDArrayIter(np.zeros((4, 5), np.float32),
                                np.zeros(4, np.float32), batch_size=4)
        mgr = pkg.executor_manager.DataParallelExecutorManager(
            _mgr_net(pkg), [pkg.cpu(0), pkg.cpu(1)], it)
        sizes[pkg.__name__] = [len(b) for b in mgr.param_arrays] + [
            e.arg_dict["data"].shape[0] for e in mgr._group.execs]
    assert sizes["mxnet_tpu_torch"] == sizes["mxnet_tpu"] == [2] * 6
    bad = tmx.sym.Group([tmx.sym.var("a"), tmx.sym.var("a")])
    with pytest.raises(MXNetError, match="duplicate argument"):
        tmx.executor_manager._check_arguments(bad)


# ---------------------------------------------------------------------------
# log, libinfo, util, test_utils
# ---------------------------------------------------------------------------
def test_log_format_and_levels_match_jax(tmp_path):
    got = {}
    for key, mx in PKG.items():
        path = tmp_path / ("%s.log" % key)
        lg = mx.log.getLogger("tail_%s" % key, filename=str(path),
                              level=mx.log.INFO)
        assert lg is mx.log.get_logger("tail_%s" % key, level=mx.log.DEBUG)
        assert lg.level == logging.DEBUG and len(lg.handlers) == 1
        lg.info("hello %d", 3)
        lg.warning("careful")
        lg.handlers[0].flush()
        lines = path.read_text().splitlines()
        got[key] = [(ln[0], ln.split("] ", 1)[1],
                     ln.split("] ", 1)[0].split(" ")[-1]) for ln in lines]
        fmt = lg.handlers[0].formatter
        rec = logging.LogRecord("n", logging.ERROR, "f", 1, "m", (), None)
        got[key + "_fmt"] = fmt.format(rec)[0] + fmt.format(rec)[14:]
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()
    assert [g[:2] for g in got["port"]] == [g[:2] for g in got["jax"]] == [
        ("I", "hello 3"), ("W", "careful")]
    assert got["port_fmt"] == got["jax_fmt"]
    for name in ("CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG", "NOTSET"):
        assert getattr(tmx.log, name) == getattr(jmx.log, name)
    stream = io.StringIO()
    h = logging.StreamHandler(stream)
    h.setFormatter(tmx.log._Formatter(colored=False))
    rec = logging.LogRecord("x.y", logging.WARNING, "f", 1, "msg %s",
                            ("a",), None)
    assert h.format(rec).startswith("W") and \
        h.format(rec).endswith(" x.y] msg a")


def test_libinfo_and_util_match_jax_keys():
    feats = tmx.libinfo.features()
    assert set(feats) == set(jmx.libinfo.features())
    assert feats["BACKEND"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
    assert feats["PALLAS"] is False
    assert feats["NATIVE_RUNTIME"] is (tmx._native.get_lib() is not None) \
        is jmx.libinfo.features()["NATIVE_RUNTIME"] is True
    paths = tmx.libinfo.find_lib_path()
    assert isinstance(paths, list) and all(p.endswith(".so") for p in paths)
    assert paths[0] == tmx._native._lib_path()
    assert tmx.libinfo.find_include_path() == \
        jmx.libinfo.find_include_path()
    assert tmx.libinfo.__version__ == jmx.libinfo.__version__
    assert tmx.util.is_np_array() is jmx.util.is_np_array() is False
    assert tmx.util.is_np_shape() is jmx.util.is_np_shape() is False
    assert tmx.util.get_gpu_count() == tmx.num_gpus()
    assert tmx.is_np_array is tmx.util.is_np_array


def test_utils_compare_numpy_torch_and_ndarrays():
    tu, ju = tmx.test_utils, jmx.test_utils
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = a + 1e-7
    for x in (a, torch.tensor(a), tmx.nd.array(a),
              torch.tensor(a).to(torch.bfloat16)):
        tu.assert_almost_equal(x, a, rtol=1e-2)
        assert tu.almost_equal(x, a, rtol=1e-2)
    assert tu.almost_equal(a, b) == ju.almost_equal(a, b)
    assert tu.same(a, a.copy()) and not tu.same(a, b)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(torch.tensor(a), a + 1)
    assert tu.default_dtype() is ju.default_dtype()
    np.random.seed(0)
    s2 = tu.rand_shape_2d()
    np.random.seed(0)
    assert s2 == ju.rand_shape_2d()
    np.random.seed(1)
    s3 = tu.rand_shape_3d()
    np.random.seed(1)
    assert s3 == ju.rand_shape_3d()
    np.random.seed(2)
    r = tu.rand_ndarray((3, 4), ctx=tmx.cpu())
    np.random.seed(2)
    np.testing.assert_array_equal(r.asnumpy(),
                                  ju.rand_ndarray((3, 4)).asnumpy())
    np.random.seed(3)
    sp = tu.rand_ndarray((6, 4), "row_sparse", density=0.5, ctx=tmx.cpu())
    np.random.seed(3)
    jsp = ju.rand_ndarray((6, 4), "row_sparse", density=0.5)
    assert sp.stype == jsp.stype == "row_sparse"
    np.testing.assert_array_equal(sp.asnumpy(), jsp.asnumpy())
    assert tu.list_gpus() == list(range(tmx.num_gpus()))
    with pytest.raises(MXNetError, match="network"):
        tu.download("http://example.invalid/x")


def test_utils_symbolic_checks_on_both_packages():
    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    for mx in PKG.values():
        tu = mx.test_utils
        data = mx.sym.var("data")
        sym = mx.sym.tanh(data)
        tu.check_symbolic_forward(sym, [x], [np.tanh(x)], ctx=mx.cpu())
        tu.check_symbolic_backward(sym, [x], [np.ones_like(x)],
                                   [1 - np.tanh(x) ** 2], ctx=mx.cpu())
        tu.check_numeric_gradient(mx.sym.sum(sym * sym), [x[:2, :2]],
                                  numeric_eps=1e-3, rtol=2e-2,
                                  ctx=mx.cpu())
        with pytest.raises(ValueError, match="unknown argument"):
            tu.check_symbolic_forward(sym, {"nope": x}, [x], ctx=mx.cpu())
    tmx.test_utils.check_consistency(
        tmx.sym.tanh(tmx.sym.var("data")),
        [{"ctx": tmx.cpu(0), "data": (2, 3)},
         {"ctx": tmx.cpu(1), "data": (2, 3)}])


def test_clean_dist_env_strips_what_jax_strips(monkeypatch):
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("MXNET_QOS_TENANTS", "a")
    monkeypatch.setenv("MXNET_PROFILER_MODE", "all")
    t = tmx.test_utils.clean_dist_env(repo_root="/r")
    j = jmx.test_utils.clean_dist_env(repo_root="/r")
    assert "DMLC_ROLE" not in t and "MXNET_QOS_TENANTS" not in t
    assert t["MXNET_PROFILER_MODE"] == "all"
    assert t["PYTHONPATH"].startswith("/r")
    # the JAX copy also pins JAX to the CPU; the port has no JAX
    j.pop("JAX_PLATFORMS")
    t.pop("JAX_PLATFORMS", None)
    assert t == j


# ---------------------------------------------------------------------------
# rtc, without a card
# ---------------------------------------------------------------------------
SOURCE = r'''
// __global__ void commented_out(int n)
extern "C" __global__ void saxpy(const float *x, float *y, float a, int n)
{ int i = blockIdx.x * blockDim.x + threadIdx.x; if (i < n) y[i] += a * x[i]; }
extern "C" {
__global__ void __launch_bounds__(256) row_max(const float *x, float *y,
                                               int n) { if (n) { } }
}
template <typename T> __global__ void scale(T *y, T a, int n) {}
__global__ void cpp_only(float *y) {}
'''


def test_rtc_signature_parser():
    from mxnet_tpu_torch import rtc

    assert rtc._parse_signature("const float *x, float *y, float a, int n") \
        == [(True, np.float32, True, "x"), (False, np.float32, True, "y"),
            (False, np.float32, False, "a"), (False, np.int32, False, "n")]
    assert rtc._parse_signature("const  __half* x ,int64_t n") == [
        (True, np.float16, True, "x"), (False, np.int64, False, "n")]
    assert rtc._parse_signature("double *, uint8_t") == [
        (False, np.float64, True, None), (False, np.uint8, False, None)]
    assert rtc._parse_signature("") == []
    with pytest.raises(MXNetError, match="unsupported kernel argument"):
        rtc._parse_signature("float2 *x")
    with pytest.raises(MXNetError, match="invalid kernel parameter"):
        rtc._parse_signature("const *x")
    with pytest.raises(MXNetError, match="invalid kernel parameter"):
        rtc._parse_signature("float *x y")


def test_rtc_kernel_names_and_missing_kernel_error():
    from mxnet_tpu_torch import rtc

    assert rtc._kernels(SOURCE) == {"saxpy": True, "row_max": True,
                                    "scale": False, "cpp_only": False}
    assert rtc._kernel_symbol(SOURCE, (), "saxpy") == "saxpy"
    assert rtc._kernel_symbol(SOURCE, ("scale<float>",),
                              "scale<float>") == "scale<float>"
    for name in ("nope", "commented_out"):
        with pytest.raises(MXNetError, match="source defines no kernel"):
            rtc._kernel_symbol(SOURCE, (), name)
    with pytest.raises(MXNetError, match="source defines no kernel"):
        rtc._kernel_symbol(SOURCE, ("other<int>",), "other<int>")
    with pytest.raises(MXNetError, match="C\\+\\+ name.*exports"):
        rtc._kernel_symbol(SOURCE, (), "cpp_only")
    # the JAX package's missing-kernel error reads the same
    jmod = jmx.rtc.CudaModule("def saxpy(a, x, y):\n    return a * x + y\n")
    with pytest.raises(jmx.MXNetError, match="source defines no kernel"):
        jmod.get_kernel("nope")


def test_rtc_refuses_without_a_card_by_name(monkeypatch):
    from mxnet_tpu_torch import rtc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="rtc: CudaModule.*no|none"):
        rtc.CudaModule(SOURCE)
    k = rtc.CudaKernel(None, "saxpy", rtc._parse_signature(
        "const float *x, float *y, float a, int n"))
    x = tmx.nd.ones((4,), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="gpu context"):
        k.launch([x, x, 1.0, 4], tmx.cpu(), (1, 1, 1), (4, 1, 1))
    with pytest.raises(MXNetError, match="gpu context"):
        k.launch([x, x, 1.0, 4], "gpu(0)", (1, 1, 1), (4, 1, 1))
    assert k.launches == 0
