"""The port's C predict ABI (``mxnet_tpu_torch.c_predict`` behind the
library that ``_native.build_predict`` builds from ``native/c_predict.cc``)
against the JAX package's, on the CPU.

- The 4 cases of ``tests/test_c_predict.py`` against the port's library:
  the round trip, partial outputs, ``NDList``, and a plain C program
  compiled by gcc against ``src/c_predict_api.h`` and the port's library,
  run standalone with ``dev_type`` 1.
- Parity: the model that ``tests/test_c_predict.py`` exports from the JAX
  package goes through the JAX ABI and the port's ABI, both in this
  process by ctypes: outputs, partial outputs and ``NDList``'s keys,
  shapes and bytes agree. A checkpoint the port saves serves through the
  port's ABI as the JAX one does.
- A tiny fused ResNet (B1's plain version on the CPU) through the port's
  ABI against the JAX package's ``AOTPredictor`` (the Pallas kernels in
  interpret mode) on the same symbol and params.
- The exact-shape bind (``AOTPredictor(ladder=None)``) that the ABI binds.

The JAX library is built from ``src/c_predict.cc`` with g++ into this
module's temporary directory (``make -C src predict`` writes
``mxnet_tpu/lib``, which ``tests/test_c_predict.py`` may be building at the
same time). Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.serving import AOTPredictor as JaxAOTPredictor
from mxnet_tpu.serving import ServingError as JaxServingError
from mxnet_tpu_torch import _native, model as tmodel, nd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.serving import AOTPredictor, ServingError
from test_c_predict import C_MAIN, _export_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 32, 32), bottle_neck=True)
TINY_SHAPE = (2, 3, 32, 32)
FP = ctypes.POINTER(ctypes.c_float)


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.MXGetLastError.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    jax_lib = tmp_path_factory.mktemp("jax_predict") / "libjax_predict.so"
    r = subprocess.run(
        ["g++", *_native.CXXFLAGS, "-I" + SRC,
         os.path.join(SRC, "c_predict.cc"), *_native.LDFLAGS,
         *_native._python_flags(), "-o", str(jax_lib)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return {"port": _load(_native.build_predict()), "jax": _load(jax_lib)}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``(prefix, x, expect)``: the JAX package's exported LeNet-ish head,
    an input and the JAX Module's output."""
    return _export_model(tmp_path_factory.mktemp("model"))


def _err(lib):
    return lib.MXGetLastError().decode()


def _files(prefix):
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read().encode()
    with open(prefix + "-0000.params", "rb") as f:
        return sym_json, f.read()


def _create(lib, prefix, batch_shape, partial_out=None):
    sym_json, params = _files(prefix)
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint * 2)(0, len(batch_shape))
    shape = (ctypes.c_uint * len(batch_shape))(*batch_shape)
    handle = ctypes.c_void_p()
    if partial_out is None:
        rc = lib.MXPredCreate(sym_json, params, len(params), 1, 0, 1, keys,
                              indptr, shape, ctypes.byref(handle))
    else:
        okeys = (ctypes.c_char_p * len(partial_out))(
            *[o.encode() for o in partial_out])
        rc = lib.MXPredCreatePartialOut(
            sym_json, params, len(params), 1, 0, 1, keys, indptr, shape,
            len(partial_out), okeys, ctypes.byref(handle))
    assert rc == 0, _err(lib)
    return handle


def _forward(lib, handle, x):
    """Set ``data``, run the forward, and return output 0 at its shape."""
    flat = np.ascontiguousarray(x.reshape(-1), np.float32)
    assert lib.MXPredSetInput(handle, b"data", flat.ctypes.data_as(FP),
                              flat.size) == 0, _err(lib)
    assert lib.MXPredForward(handle) == 0, _err(lib)
    sdata = ctypes.POINTER(ctypes.c_uint)()
    sndim = ctypes.c_uint()
    assert lib.MXPredGetOutputShape(handle, 0, ctypes.byref(sdata),
                                    ctypes.byref(sndim)) == 0, _err(lib)
    shape = tuple(sdata[i] for i in range(sndim.value))
    out = np.zeros(int(np.prod(shape)), np.float32)
    assert lib.MXPredGetOutput(handle, 0, out.ctypes.data_as(FP),
                               out.size) == 0, _err(lib)
    return out.reshape(shape)


def _predict(lib, prefix, x, partial_out=None):
    handle = _create(lib, prefix, x.shape, partial_out)
    try:
        return _forward(lib, handle, x)
    finally:
        assert lib.MXPredFree(handle) == 0


def test_predict_roundtrip(libs, exported):
    prefix, x, expect = exported
    lib = libs["port"]
    handle = _create(lib, prefix, (2, 5))
    got = _forward(lib, handle, x)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, **TOL)
    np.testing.assert_allclose(got, _predict(libs["jax"], prefix, x), **TOL)
    # the partial-forward stepper runs the whole program at step 0
    left = ctypes.c_int(-1)
    assert lib.MXPredPartialForward(handle, 0, ctypes.byref(left)) == 0
    assert left.value == 0
    # an input of the wrong size is refused with the backend's message
    flat = np.zeros(3, np.float32)
    assert lib.MXPredSetInput(handle, b"data", flat.ctypes.data_as(FP),
                              3) != 0
    assert "expected 10 floats, got 3" in _err(lib)
    assert lib.MXPredFree(handle) == 0


def test_predict_partial_out(libs, exported):
    prefix, x, _ = exported
    got = _predict(libs["port"], prefix, x, partial_out=["fc1"])
    assert got.shape == (2, 8)
    np.testing.assert_allclose(
        got, _predict(libs["jax"], prefix, x, partial_out=["fc1"]), **TOL)


def _ndlist(lib, params):
    handle = ctypes.c_void_p()
    length = ctypes.c_uint()
    assert lib.MXNDListCreate(params, len(params), ctypes.byref(handle),
                              ctypes.byref(length)) == 0, _err(lib)
    out = {}
    for i in range(length.value):
        key = ctypes.c_char_p()
        data = FP()
        shp = ctypes.POINTER(ctypes.c_uint)()
        ndim = ctypes.c_uint()
        assert lib.MXNDListGet(handle, i, ctypes.byref(key),
                               ctypes.byref(data), ctypes.byref(shp),
                               ctypes.byref(ndim)) == 0, _err(lib)
        shape = tuple(shp[j] for j in range(ndim.value))
        out[key.value.decode()] = (shape, np.ctypeslib.as_array(
            data, shape=(int(np.prod(shape)),)).tobytes())
    assert lib.MXNDListFree(handle) == 0
    return out


def test_ndlist(libs, exported):
    prefix, _, _ = exported
    _, params = _files(prefix)
    got = _ndlist(libs["port"], params)
    assert len(got) >= 4   # fc1 and fc2, weight and bias
    assert "fc1_weight" in got and "fc2_bias" in got, sorted(got)
    for shape, raw in got.values():
        assert np.isfinite(np.frombuffer(raw, np.float32)).all()
        assert len(raw) == 4 * int(np.prod(shape))
    assert got == _ndlist(libs["jax"], params)


def test_a_port_checkpoint_serves_through_the_port_abi(libs, exported,
                                                       tmp_path):
    prefix, x, _ = exported
    sym, args, auxs = tmodel.load_checkpoint(prefix, 0)
    port_prefix = str(tmp_path / "port")
    tmodel.save_checkpoint(port_prefix, 0, sym, args, auxs)
    np.testing.assert_array_equal(_predict(libs["port"], port_prefix, x),
                                  _predict(libs["port"], prefix, x))


def test_pure_c_consumer(libs, exported, tmp_path):
    """A plain C main compiled against the ABI's header and the port's
    library only, run standalone with its own embedded interpreter."""
    prefix, _, _ = exported
    csrc = tmp_path / "main.c"
    csrc.write_text(C_MAIN)
    exe = str(tmp_path / "cpred")
    lib = _native.build_predict()
    r = subprocess.run(["gcc", str(csrc), "-I", SRC, lib,
                        "-Wl,-rpath," + os.path.dirname(lib), "-o", exe],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    paths = sysconfig.get_paths()
    env = dict(os.environ, MXNET_TPU_HOME=ROOT, PYTHONPATH=os.pathsep.join(
        [ROOT, paths["purelib"], paths["platlib"]]))
    r = subprocess.run([exe, prefix + "-symbol.json", prefix + "-0000.params"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "C_PREDICT_OK ndim=2 n=6" in r.stdout, r.stdout
    rowsum = float(r.stdout.split("rowsum=")[1].split()[0])
    assert abs(rowsum - 1.0) < 1e-3, r.stdout


def test_tiny_fused_resnet_through_the_abi_matches_jax(libs, tmp_path,
                                                       monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    sym = tresnet.resnet(fused=True, **TINY)
    args, auxs = tresnet.init_params(sym, TINY_SHAPE, seed=0)
    rng = np.random.RandomState(1)
    for name, v in auxs.items():   # BN statistics off their identity
        auxs[name] = (rng.uniform(0.6, 1.6, v.shape) if name.endswith("_var")
                      else rng.normal(0, 0.2, v.shape)).astype(np.float32)
    prefix = str(tmp_path / "tiny")
    tmodel.save_checkpoint(
        prefix, 0, sym, {k: nd.array(v, ctx=cpu()) for k, v in args.items()},
        {k: nd.array(v, ctx=cpu()) for k, v in auxs.items()})
    x = np.random.RandomState(2).randn(*TINY_SHAPE).astype(np.float32)
    got = _predict(libs["port"], prefix, x, partial_out=["fc1"])
    want = np.asarray(JaxAOTPredictor(
        jresnet.resnet(fused=True, **TINY), args, auxs,
        data_shapes={"data": TINY_SHAPE}, ladder=None,
        output_names=["fc1_output"]).predict(x)[0])
    scale = float(np.abs(want).max())
    assert got.shape == want.shape == (2, TINY["num_classes"])
    assert 0.1 < scale < 100
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_exact_shape_bind_matches_jax(exported):
    prefix, x, _ = exported
    sym, args, auxs = tmodel.load_checkpoint(prefix, 0)
    with pytest.warns(UserWarning, match="softmax_label"):
        pred = AOTPredictor(sym, args, auxs, data_shapes={"data": (2, 5)},
                            ladder=None, device="cpu")
    assert pred.ladder is None and pred.max_bucket is None
    assert pred.num_outputs == 1
    np.testing.assert_allclose(pred.predict(x)[0], exported[2], **TOL)
    with pytest.raises(ServingError, match="exact-bound predictor"):
        pred.predict(x[:1])
    with pytest.raises(ServingError, match="exact shapes"):
        pred.pick_bucket(1)
    import mxnet_tpu as jmx

    jsym, jargs, jauxs = jmx.model.load_checkpoint(prefix, 0)
    jpred = JaxAOTPredictor(jsym, jargs, jauxs, data_shapes={"data": (2, 5)},
                            ladder=None)
    with pytest.raises(JaxServingError, match="exact-bound predictor"):
        jpred.predict(x[:1])
    assert jpred.num_outputs == pred.num_outputs
