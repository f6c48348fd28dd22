"""The PyTorch port's NDArray, its file format, autograd and random streams
against the JAX package, on the CPU.

- ``nd.save``/``nd.load`` across the packages, bit for bit, for lists and
  dicts and every dtype a JAX NDArray can hold (bfloat16 in the form the
  JAX package writes it: numpy's raw ``<V2``);
- a parametrised sweep of NDArray methods, operators, in-place operators
  and view writes against the JAX ``NDArray`` on the same seeded inputs;
- ``autograd.record``/``pause``/``backward``/``grad`` and a custom
  ``Function`` against the JAX autograd;
- ``mx.random.seed`` reseeding the initializers as the JAX package does;
- the default context being ``gpu(0)`` (raising without a card), and no
  port module importing ``jax`` or ``mxnet_tpu`` (a subprocess).

Tolerance: fp32 on both sides, rtol 1e-4 and an atol of 1e-5 of the
reference's largest |value| (the order of sums only); files and integer
results bit for bit.
"""
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got.astype(np.float64), want.astype(np.float64), rtol=RTOL,
        atol=ATOL * max(float(np.abs(want).max()) if want.size else 0, 1.0),
        err_msg=what)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _bits(a):
    """The raw bits of a numpy array (bfloat16 as ml_dtypes gives it)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).tobytes(), a.shape


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------
# every dtype a JAX NDArray holds (64-bit types are off there)
JAX_DTYPES = ["float32", "float16", "bfloat16", "uint8", "int8", "int32",
              "bool"]


def _values(dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(3, 5) > 0.5
    if dtype in ("uint8", "int8", "int32"):
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max, (3, 5)).astype(dtype)
    return (rng.randn(3, 5) * 100).astype(np.float32)


def _jax_array(dtype, seed):
    return jmx.nd.array(_values(dtype, seed)).astype(dtype)


def _port_bits(arr):
    t = arr.tensor
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8).tobytes(), tuple(arr.shape)


def _jax_bits(arr):
    a = np.asarray(arr.asnumpy())
    if arr.dtype.__name__ == "bfloat16" if hasattr(arr.dtype, "__name__") \
            else str(arr.dtype) == "bfloat16":
        a = a.view(np.int16)
    return a.view(np.uint8).tobytes(), a.shape


@pytest.mark.parametrize("container", ["list", "dict"])
def test_jax_files_load_bit_exact_in_the_port(tmp_path, container):
    arrays = [_jax_array(d, i) for i, d in enumerate(JAX_DTYPES)]
    fname = str(tmp_path / "jax.params")
    if container == "list":
        jmx.nd.save(fname, arrays)
        got = mx.nd.load(fname)
        assert isinstance(got, list) and len(got) == len(arrays)
    else:
        jmx.nd.save(fname, dict(zip(JAX_DTYPES, arrays)))
        got = mx.nd.load(fname)
        assert sorted(got) == sorted(JAX_DTYPES)
        got = [got[d] for d in JAX_DTYPES]
    for dtype, g, a in zip(JAX_DTYPES, got, arrays):
        assert str(g.tensor.dtype) == "torch." + dtype, dtype
        assert g.context == mx.cpu()
        assert _port_bits(g) == _jax_bits(a), dtype


@pytest.mark.parametrize("container", ["list", "dict"])
def test_port_files_load_bit_exact_in_jax(tmp_path, container):
    """Every dtype but bfloat16 round-trips into the JAX package; the
    bfloat16 entry is byte for byte the one the JAX package writes (whose
    own ``nd.load`` refuses it: ROADMAP Queue C)."""
    dtypes = [d for d in JAX_DTYPES if d != "bfloat16"]
    arrays = [mx.nd.array(_values(d, i)).astype(d)
              for i, d in enumerate(dtypes)]
    fname = str(tmp_path / "port.params")
    if container == "list":
        mx.nd.save(fname, arrays)
        got = jmx.nd.load(fname)
    else:
        mx.nd.save(fname, dict(zip(dtypes, arrays)))
        got = jmx.nd.load(fname)
        got = [got[d] for d in dtypes]
    for dtype, g, a in zip(dtypes, got, arrays):
        assert np.dtype(g.dtype).name == dtype, dtype
        assert _jax_bits(g) == _port_bits(a), dtype


def test_bfloat16_entries_are_the_jax_packages_bytes(tmp_path):
    vals = _values("float32", 3)
    jmx.nd.save(str(tmp_path / "j.npz"),
                {"w": jmx.nd.array(vals).astype("bfloat16")})
    mx.nd.save(str(tmp_path / "t.npz"),
               {"w": mx.nd.array(vals).astype("bfloat16")})
    entries = [zipfile.ZipFile(str(tmp_path / f)).read("w.npy")
               for f in ("j.npz", "t.npz")]
    assert entries[0] == entries[1]
    assert b"'descr': '<V2'" in entries[1]
    with pytest.raises(TypeError):     # the JAX package's own load
        jmx.nd.load(str(tmp_path / "j.npz"))


def test_round_trip_through_both_packages(tmp_path):
    arrays = {d: _jax_array(d, 10 + i) for i, d in enumerate(JAX_DTYPES)
              if d != "bfloat16"}
    jmx.nd.save(str(tmp_path / "a"), arrays)
    mx.nd.save(str(tmp_path / "b"), mx.nd.load(str(tmp_path / "a")))
    back = jmx.nd.load(str(tmp_path / "b"))
    for d, a in arrays.items():
        assert np.dtype(back[d].dtype) == np.dtype(a.dtype), d
        assert _jax_bits(back[d]) == _jax_bits(a), d


def test_files_hold_no_pickles(tmp_path):
    fname = str(tmp_path / "x.params")
    mx.nd.save(fname, [mx.nd.array([1.0, 2.0])])
    with np.load(fname, allow_pickle=False) as npz:
        assert list(npz.keys()) == ["__mx_list_0"]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.array([{"a": 1}], dtype=object))
    with pytest.raises(ValueError):
        mx.nd.load(bad)
    with pytest.raises(MXNetError):
        mx.nd.save(fname, 3)


# ---------------------------------------------------------------------------
# NDArray methods
# ---------------------------------------------------------------------------
def _pair(seed=0, shape=(3, 4, 5), positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if positive:
        x = np.abs(x) + 0.5
    return mx.nd.array(x), jmx.nd.array(x)


METHODS = {
    "sum": lambda a: a.sum(), "sum_axis": lambda a: a.sum(axis=1),
    "sum_keep": lambda a: a.sum(axis=(0, 2), keepdims=True),
    "mean": lambda a: a.mean(axis=2), "max": lambda a: a.max(axis=0),
    "min": lambda a: a.min(), "prod": lambda a: a.prod(axis=1),
    "argmax": lambda a: a.argmax(axis=1), "argmin": lambda a: a.argmin(),
    "norm": lambda a: a.norm(), "abs": lambda a: a.abs(),
    "sign": lambda a: a.sign(), "square": lambda a: a.square(),
    "exp": lambda a: a.exp(), "relu": lambda a: a.relu(),
    "sigmoid": lambda a: a.sigmoid(), "tanh": lambda a: a.tanh(),
    "clip": lambda a: a.clip(-0.5, 0.7), "round": lambda a: a.round(),
    "floor": lambda a: a.floor(), "ceil": lambda a: a.ceil(),
    "softmax": lambda a: a.softmax(), "log_softmax": lambda a: a.log_softmax(),
    "reshape": lambda a: a.reshape((4, -1)),
    "reshape_codes": lambda a: a.reshape((0, -3)),
    "reshape_split": lambda a: a.reshape((-4, 1, 3, -2)),
    "transpose": lambda a: a.transpose((2, 0, 1)), "T": lambda a: a.T,
    "expand_dims": lambda a: a.expand_dims(1), "flatten": lambda a: a.flatten(),
    "squeeze": lambda a: a.expand_dims(0).squeeze(),
    "swapaxes": lambda a: a.swapaxes(0, 2),
    "broadcast_to": lambda a: a[:, :1].broadcast_to((3, 4, 5)),
    "take": lambda a: a.take(a[0, :2, 0].abs().floor()),
    "astype": lambda a: a.astype("float16").astype("float32"),
    "copy": lambda a: a.copy(), "slice": lambda a: a[1:, ::2, 3],
    "int_index": lambda a: a[2], "neg": lambda a: -a,
    "add": lambda a: a + a * 2, "sub_scalar": lambda a: a - 1.5,
    "rsub": lambda a: 3 - a, "mul": lambda a: a * a,
    "div": lambda a: a / (a.abs() + 1), "rdiv": lambda a: 2.0 / (a.abs() + 1),
    "pow": lambda a: a.abs() ** 1.5, "rpow": lambda a: 2.0 ** a,
    "mod": lambda a: a % 0.7, "eq": lambda a: a == a.round(),
    "gt": lambda a: a > 0.1, "le": lambda a: a <= a[0],
    "ne_scalar": lambda a: a != 0, "numpy_rhs": lambda a: a + np.ones(5),
}
POSITIVE = {"sqrt": lambda a: a.sqrt(), "log": lambda a: a.log()}


@pytest.mark.parametrize("name", sorted(METHODS) + sorted(POSITIVE))
def test_ndarray_method_matches_jax(name):
    fn = METHODS.get(name) or POSITIVE[name]
    t, j = _pair(positive=name in POSITIVE)
    got, want = fn(t), fn(j)
    assert isinstance(got, mx.nd.NDArray)
    _close(got.asnumpy(), want.asnumpy(), name)
    assert np.dtype(got.dtype) == np.dtype(want.dtype), name


def test_dot_matches_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(4, 6).astype(np.float32), rng.randn(6, 3).astype(
        np.float32)
    got = mx.nd.dot(mx.nd.array(a), mx.nd.array(b))
    _close(got.asnumpy(), jmx.nd.dot(jmx.nd.array(a), jmx.nd.array(b))
           .asnumpy())
    got = mx.nd.array(a).dot(mx.nd.array(a), transpose_b=True)
    _close(got.asnumpy(), jmx.nd.array(a).dot(jmx.nd.array(a),
                                              transpose_b=True).asnumpy())


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
@pytest.mark.parametrize("rhs", ["scalar", "array"])
def test_inplace_operators_write_the_same_tensor(op, rhs):
    t, j = _pair(2)
    other = 1.25 if rhs == "scalar" else None
    if other is None:
        ot, oj = _pair(3)
        ot, oj = ot.abs() + 1, oj.abs() + 1
    else:
        ot = oj = other
    tensor = t.tensor
    view = t[1]
    exec(compile("t %s ot\nj %s oj" % (op, op), "<inplace>", "exec"))
    assert t.tensor is tensor
    _close(t.asnumpy(), j.asnumpy(), op)
    _close(view.asnumpy(), j.asnumpy()[1], "view sees the write")


@pytest.mark.parametrize("key,value", [
    (slice(None), 3.0), ((1, slice(0, 2)), -1.0), (2, "array"),
    ((slice(None), 1, slice(1, 4)), "array"), (0, "ndarray")])
def test_setitem_matches_jax(key, value):
    t, j = _pair(4)
    shape = np.asarray(j.asnumpy()[key]).shape
    if value == "array":
        value = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
            shape)
        vt = vj = value
    elif value == "ndarray":
        v = np.full(shape, 5.5, np.float32)
        vt, vj = mx.nd.array(v), jmx.nd.array(v)
    else:
        vt = vj = value
    t[key] = vt
    j[key] = vj
    _close(t.asnumpy(), j.asnumpy())


def test_views_write_through_to_the_parent():
    t, j = _pair(5)
    for arr in (t, j):
        row = arr[1:3]
        row[:] = 9.0
        sub = row[1]
        sub[:] = -2.0
        row += 1
    _close(t.asnumpy(), j.asnumpy())
    assert float(t[2, 0, 0].asscalar()) == -1.0
    # an index array gathers a copy: writing it leaves the parent alone
    g = t[mx.nd.array([0, 2])]
    g[:] = 100.0
    assert float(t.max().asscalar()) < 100.0


def test_creation_and_conversion():
    assert mx.nd.zeros((2, 3)).asnumpy().sum() == 0
    assert mx.nd.ones(4, dtype="int32").dtype == np.int32
    assert mx.nd.full((2,), 7.5).asnumpy().tolist() == [7.5, 7.5]
    assert mx.nd.empty((2, 2)).shape == (2, 2)
    np.testing.assert_array_equal(mx.nd.arange(2, 11, 3).asnumpy(),
                                  jmx.nd.arange(2, 11, 3).asnumpy())
    assert mx.nd.array([1, 2]).dtype == np.float32
    assert mx.nd.array(np.arange(3.0)).dtype == np.float32
    assert mx.nd.array(np.arange(3, dtype=np.int32)).dtype == np.int32
    a = mx.nd.array([[1.0, 2.0]])
    assert a.copyto(mx.cpu()).asnumpy().tolist() == [[1.0, 2.0]]
    assert a.as_in_context(mx.cpu()) is a
    b = mx.nd.zeros((1, 2))
    a.copyto(b)
    assert b.asnumpy().tolist() == [[1.0, 2.0]]
    assert mx.nd.array([3.0]).asscalar() == 3.0
    with pytest.raises(MXNetError, match="not a scalar"):
        a.asscalar()
    c = mx.nd.concatenate([a, a])
    assert c.shape == (2, 2)
    a.wait_to_read()
    mx.nd.waitall()


def test_unported_ops_raise_by_name():
    # the registry holds all of the JAX package's names (``Custom`` was the
    # last); a name of MXNet's that neither package has still raises
    assert mx.nd.Custom is not None
    with pytest.raises(MXNetError, match="_image_to_tensor.*not ported"):
        mx.nd._image_to_tensor
    with pytest.raises(MXNetError, match="'_image_to_tensor' is not ported"):
        mx.nd.invoke("_image_to_tensor", [mx.nd.zeros(3)], {})
    # sparse storage is ported: tostype("csr") gives the JAX package's CSR
    dense = np.array([[0, 1.5, 0], [2, 0, 0]], np.float32)
    csr = mx.nd.array(dense).tostype("csr")
    jcsr = jmx.nd.array(dense).tostype("csr")
    assert csr.stype == jcsr.stype == "csr"
    assert csr.indptr.asnumpy().tolist() == jcsr.indptr.asnumpy().tolist()
    assert csr.indices.asnumpy().tolist() == jcsr.indices.asnumpy().tolist()
    assert (csr.asnumpy() == jcsr.asnumpy()).all()
    assert callable(mx.nd.sgd_mom_update) and callable(mx.nd.broadcast_add)


def test_generated_op_functions():
    t, j = _pair(6)
    _close(mx.nd.broadcast_mul(t, t).asnumpy(),
           jmx.nd.broadcast_mul(j, j).asnumpy())
    _close(mx.nd.sum(t, axis=0).asnumpy(), jmx.nd.sum(j, axis=0).asnumpy())
    _close(mx.nd.clip(t, -0.1, 0.2).asnumpy(),
           jmx.nd.clip(j, -0.1, 0.2).asnumpy())
    out = mx.nd.zeros(t.shape)
    mx.nd.relu(t, out=out)
    _close(out.asnumpy(), jmx.nd.relu(j).asnumpy())


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _both_grads(fn, req="write", head=None, repeat=1):
    """fn(ag, x, w) under record in each package; the gradients of x and
    w after ``repeat`` backward passes."""
    out = []
    for pkg in (mx, jmx):
        rng = np.random.RandomState(7)
        x = pkg.nd.array(rng.randn(4, 3).astype(np.float32))
        w = pkg.nd.array(rng.randn(3, 2).astype(np.float32))
        x.attach_grad(grad_req=req)
        w.attach_grad(grad_req=req)
        for _ in range(repeat):
            with pkg.autograd.record():
                y = fn(pkg, x, w)
            y.backward(None if head is None else pkg.nd.array(head))
        out.append((x.grad.asnumpy(), w.grad.asnumpy(), y.asnumpy()))
    return out


@pytest.mark.parametrize("case", ["matmul", "elementwise", "pause", "add"])
def test_autograd_backward_matches_jax(case):
    def fn(pkg, x, w):
        if case == "pause":
            with pkg.autograd.pause():
                c = (x * 2).sum()          # not recorded: a constant
            return pkg.nd.dot(x, w).tanh() * c
        if case == "elementwise":
            return (x.sigmoid() * x - x.square().sum(axis=1,
                                                      keepdims=True))
        return pkg.nd.dot(x, w).relu() + w.sum()

    head = np.linspace(-1, 1, 8).reshape(4, 2).astype(np.float32) \
        if case in ("matmul", "pause", "add") else None
    (tx, tw, ty), (jx, jw, jy) = _both_grads(
        fn, req="add" if case == "add" else "write", head=head,
        repeat=2 if case == "add" else 1)
    _close(ty, jy)
    _close(tx, jx, "x grad")
    _close(tw, jw, "w grad")


def test_autograd_flags_and_null_req():
    assert not mx.autograd.is_recording() and not mx.autograd.is_training()
    with mx.autograd.record():
        assert mx.autograd.is_recording() and mx.autograd.is_training()
        with mx.autograd.pause():
            assert not mx.autograd.is_recording()
        with mx.autograd.predict_mode():
            assert not mx.autograd.is_training()
    with mx.autograd.train_mode():
        assert mx.autograd.is_training()
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="null")
    with mx.autograd.record():
        y = x * 3
    y.backward()
    assert x.grad.asnumpy().tolist() == [0.0, 0.0]
    with pytest.raises(MXNetError, match="not in a recorded graph"):
        mx.nd.array([1.0]).backward()


def test_autograd_grad_matches_jax():
    out = []
    for pkg in (mx, jmx):
        x = pkg.nd.array(np.linspace(-2, 2, 6).astype(np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
        (g,) = pkg.autograd.grad(y, [x])
        out.append((g.asnumpy(), x.grad.asnumpy()))
    _close(out[0][0], out[1][0])
    assert not out[0][1].any() and not out[1][1].any()


def test_custom_function_matches_jax():
    def make(pkg):
        class Scale(pkg.autograd.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * 3 + 1

            def backward(self, dy):
                (x,) = self.saved_tensors
                return dy * 3 + x * 0

        return Scale()

    out = []
    for pkg in (mx, jmx):
        x = pkg.nd.array(np.arange(4, dtype=np.float32))
        x.attach_grad()
        f = make(pkg)
        with pkg.autograd.record():
            y = (f(x) * x).sum()
        y.backward()
        out.append((y.asnumpy(), x.grad.asnumpy()))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# random, contexts, imports
# ---------------------------------------------------------------------------
def test_random_seed_reseeds_the_initializers_as_jax_does():
    shape = (5, 4, 3, 3)
    mx.random.seed(123)
    jmx.random.seed(123)
    t, j = mx.nd.zeros(shape), jmx.nd.zeros(shape)
    mx.init.Xavier()("c_weight", t)
    jmx.initializer.Xavier()("c_weight", j)
    assert np.array_equal(t.asnumpy(), j.asnumpy())
    for init in (mx.init.MSRAPrelu(), mx.init.Orthogonal(),
                 mx.init.Bilinear()):
        mx.random.seed(5)
        jmx.random.seed(5)
        t, j = mx.nd.zeros((4, 3, 3, 3)), jmx.nd.zeros((4, 3, 3, 3))
        init("u_weight", t)
        getattr(jmx.initializer, type(init).__name__)()("u_weight", j)
        assert np.array_equal(t.asnumpy(), j.asnumpy()), type(init)


def test_device_streams_are_seeded_per_device():
    mx.random.seed(3)
    a = mx.random.uniform(0, 1, (4,), ctx=mx.cpu()).asnumpy()
    b = mx.random.uniform(0, 1, (4,), ctx=mx.cpu()).asnumpy()
    mx.random.seed(3)
    assert np.array_equal(mx.random.uniform(0, 1, (4,)).asnumpy(), a)
    assert not np.array_equal(a, b)
    assert mx.random.normal(0, 1, (1000,)).asnumpy().std() == \
        pytest.approx(1.0, abs=0.1)


def test_default_context_is_the_card():
    assert mx.Context.default_ctx() == mx.cpu()        # this file's scope
    with mx.gpu(0):
        assert mx.current_context() == mx.gpu(0)
    if torch.cuda.is_available():
        return
    t = threading_default_ctx()
    assert t == mx.gpu(0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gpu(0).torch_device()
    with mx.gpu(0):
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.nd.zeros(3)


def test_load_defaults_to_the_current_context(tmp_path):
    """``nd.load`` places its arrays as ``nd.array`` does: on the current
    context, ``gpu(0)`` outside any ``with`` block (raising without a
    card). Checkpoints are staged on the CPU on purpose, for ``Module``'s
    host copies, whatever the current context."""
    import threading

    prefix = str(tmp_path / "ck")
    mx.model.save_checkpoint(prefix, 1, mx.sym.Variable("w"),
                             {"w": mx.nd.array([1.0, 2.0])}, {})
    fname = prefix + "-0001.params"
    assert mx.nd.load(fname)["arg:w"].context == mx.cpu()
    with mx.gpu(0):
        _, args, _ = mx.model.load_checkpoint(prefix, 1)
        assert args["w"].context == mx.cpu()
    out = []

    def fresh():
        try:
            out.append(mx.nd.load(fname)["arg:w"].context)
        except MXNetError as e:
            out.append(e)

    th = threading.Thread(target=fresh)
    th.start()
    th.join()
    if torch.cuda.is_available():
        assert out[0] == mx.gpu(0)
    else:
        assert isinstance(out[0], MXNetError)
        assert "no CUDA device" in str(out[0])


def threading_default_ctx():
    """The default context of a fresh thread (no ``with`` block)."""
    import threading

    out = []
    th = threading.Thread(target=lambda: out.append(mx.current_context()))
    th.start()
    th.join()
    return out[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.module, "
            "mxnet_tpu_torch.executor, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.model, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.ndarray.utils, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.random, mxnet_tpu_torch.models.resnet, "
            "mxnet_tpu_torch.parallel.tensor_parallel, "
            "mxnet_tpu_torch.serving.generate, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch.data, mxnet_tpu_torch.data.service, "
            "mxnet_tpu_torch.data.writer, mxnet_tpu_torch.data.lease, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.image.recordio_iter, "
            "mxnet_tpu_torch.parallel.feed, mxnet_tpu_torch.ndarray.sparse, "
            "mxnet_tpu_torch.tracker, mxnet_tpu_torch.kvstore_server, "
            "mxnet_tpu_torch.embedding, mxnet_tpu_torch.embedding.table, "
            "mxnet_tpu_torch.embedding.sharding, mxnet_tpu_torch.gluon, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.gluon.data.dataloader, "
            "mxnet_tpu_torch.embedding.block, mxnet_tpu_torch.gluon.rnn, "
            "mxnet_tpu_torch.gluon.contrib.rnn, "
            "mxnet_tpu_torch.gluon.data.vision, "
            "mxnet_tpu_torch.module.bucketing_module, "
            "mxnet_tpu_torch.module.sequential_module, "
            "mxnet_tpu_torch.module.python_module, "
            "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.health, "
            "mxnet_tpu_torch.embedding.checkpoint, mxnet_tpu_torch.dist, "
            "mxnet_tpu_torch.launch, mxnet_tpu_torch.engine, "
            "mxnet_tpu_torch.storage, mxnet_tpu_torch._native, "
            "mxnet_tpu_torch.c_predict, chip_smoke\n"
            "assert all(hasattr(mxnet_tpu_torch, n) for n in ('profiler', "
            "'ir', 'serving', 'embedding', 'kvstore_server', 'tracker', "
            "'chaos', 'rnd', 'Executor', 'num_gpus', 'cpu_pinned', "
            "'dist', 'engine', 'storage'))\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_c_shim_imports_only_the_port():
    """The port's C predict library embeds Python and imports its backend
    by name: ``mxnet_tpu_torch.c_predict``, never a JAX package module."""
    shim = os.path.join(ROOT, "mxnet_tpu_torch", "native")
    with open(os.path.join(shim, "c_predict.cc")) as f:
        cc = f.read()
    assert 'import_backend("mxnet_tpu_torch.c_predict")' in cc
    for name in ("c_predict.cc", "embed_common.h"):
        with open(os.path.join(shim, name)) as f:
            assert "mxnet_tpu." not in f.read(), name
