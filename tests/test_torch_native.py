"""The port's host runtime (``mxnet_tpu_torch._native``, ``engine``,
``storage`` and the native RecordIO route) against the JAX package, on the
CPU.

- The 13 cases of ``tests/test_native.py`` at the same sizes, against the
  port: the engine's ordering, serialised writers, the random-dependency
  stress, deduplicated vars, an unknown var, ``wait_for_var`` and the
  factory; the pool's reuse and stats, views and zero-sized arrays; native
  and Python RecordIO in the four writer/reader pairs, split records and
  the indexed reader.
- Records and ``.idx`` files cross between the packages' native routes bit
  for bit, both ways.
- ``MXNET_TPU_NO_NATIVE=1`` in a fresh process: the Python route and
  ``NaiveEngine``, no warning.
- Two processes building into one fresh directory both load a whole
  library.
- A ``torch.from_numpy`` tensor keeps a pooled buffer alive.

The runtime builds once (cached by the hash of its sources and flags), not
once a test.
"""
import gc
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chip_smoke import engine_stress
from mxnet_tpu import _native as jnative
from mxnet_tpu import recordio as jrecordio
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import engine as mxe
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.storage import StoragePool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def route(monkeypatch):
    """``route(native)`` switches the port's RecordIO route for the calls
    that follow, as ``MXNET_TPU_NO_NATIVE`` does for a process; the
    library is reloaded after the test."""
    def switch(native):
        monkeypatch.setenv("MXNET_TPU_NO_NATIVE", "0" if native else "1")
        _native._LIB = None
        assert (_native.get_lib() is not None) == native, \
            _native.last_error()

    yield switch
    monkeypatch.delenv("MXNET_TPU_NO_NATIVE", raising=False)
    _native._LIB = None


def test_the_runtime_builds_and_loads():
    assert _native.get_lib() is not None, _native.last_error()
    assert os.path.basename(_native._lib_path()).startswith(
        "libmxtpu_runtime-")
    assert os.path.dirname(_native._lib_path()) == _native.BUILD_DIR


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def test_engine_write_read_ordering():
    eng = mxe.ThreadedEngine(4)
    v = eng.new_var()
    order = []

    def slow_write():
        time.sleep(0.05)
        order.append("w1")

    eng.push(slow_write, mutable_vars=[v])
    eng.push(lambda: order.append("r1"), const_vars=[v])
    eng.push(lambda: order.append("r2"), const_vars=[v])
    eng.push(lambda: order.append("w2"), mutable_vars=[v])
    eng.wait_for_all()
    assert order[0] == "w1" and order[-1] == "w2"
    assert set(order[1:3]) == {"r1", "r2"}


def test_engine_serializes_writers():
    eng = mxe.ThreadedEngine(8)
    v = eng.new_var()
    state = {"x": 0}

    def inc():
        # read-modify-write: right only if writes are exclusive and ordered
        cur = state["x"]
        state["x"] = cur + 1

    for _ in range(2000):
        eng.push(inc, mutable_vars=[v])
    eng.wait_for_all()
    assert state["x"] == 2000
    assert eng.stats() == {"pushed": 2000, "executed": 2000}


def test_engine_random_dependency_stress():
    """tests/test_native.py's stress (chip_smoke.py runs the same on the
    card): writers of random var sets, each checking that it sees every var
    at the version program order gives it."""
    eng = mxe.ThreadedEngine(8)
    failures = engine_stress(np, eng)
    assert not failures, failures[:5]
    assert eng.stats() == {"pushed": 300, "executed": 300}


def test_engine_dedups_overlapping_vars():
    """The same var as const and mutable, or twice, must not deadlock."""
    eng = mxe.ThreadedEngine(2)
    v = eng.new_var()
    out = []
    eng.push(lambda: out.append(1), const_vars=[v], mutable_vars=[v])
    eng.push(lambda: out.append(2), const_vars=[v, v])
    eng.push(lambda: out.append(3), mutable_vars=[v, v])
    eng.wait_for_all()
    assert out == [1, 2, 3]


def test_engine_wait_unknown_var_raises():
    eng = mxe.ThreadedEngine(2)
    with pytest.raises(mxe.MXNetError, match="wait_for_var failed"):
        eng.wait_for_var(10**9)


def test_engine_wait_for_var():
    eng = mxe.ThreadedEngine(2)
    v = eng.new_var()
    done = []

    def slow():
        time.sleep(0.1)
        done.append(1)

    eng.push(slow, mutable_vars=[v])
    eng.wait_for_var(v)
    assert done == [1]


def test_naive_engine_and_factory():
    eng = mxe.NaiveEngine()
    out = []
    eng.push(lambda: out.append(1), mutable_vars=[eng.new_var()])
    assert out == [1]
    assert mxe.create("NaiveEngine").__class__ is mxe.NaiveEngine
    assert mxe.create("ThreadedEnginePerDevice").__class__ is \
        mxe.ThreadedEngine
    with pytest.raises(mxe.MXNetError, match="unknown engine type"):
        mxe.create("Bogus")
    prev = mxe.set_bulk_size(16)
    with mxe.bulk(32):
        assert mxe.set_bulk_size(32) == 32
    assert mxe.set_bulk_size(prev) == 16
    import mxnet_tpu_torch as mx

    assert mx.engine.bulk is mxe.bulk


# ---------------------------------------------------------------------------
# storage pool
# ---------------------------------------------------------------------------
def test_storage_pool_reuse_and_stats():
    pool = StoragePool(1 << 22)
    a = pool.empty((64, 64), np.float32)
    a[:] = 2.0
    assert float(a.sum()) == 2.0 * 64 * 64
    del a
    gc.collect()
    b = pool.empty((64, 64), np.float32)  # the same bucket: a pool hit
    st = pool.stats()
    assert st["hits"] >= 1
    assert st["live_bytes"] > 0
    del b
    gc.collect()
    pool.drain()
    assert pool.stats()["cached_bytes"] == 0


def test_storage_pool_views_keep_buffer_alive():
    pool = StoragePool(1 << 20)
    a = pool.empty((32, 32), np.float32)
    a[:] = 7.0
    view = a[3:5]
    del a
    gc.collect()
    # the buffer must not be recycled while a view exists
    assert float(view.sum()) == 7.0 * 2 * 32


def test_storage_pool_zero_sized():
    pool = StoragePool(1 << 16)
    z = pool.empty((0, 4), np.float32)
    assert z.shape == (0, 4) and z.size == 0


def test_torch_tensor_keeps_pooled_buffer_alive():
    pool = StoragePool(1 << 20)
    a = pool.empty((16, 16), np.float32)
    a[:] = 3.0
    live = pool.stats()["live_bytes"]      # the buffer's size bucket
    assert live >= 16 * 16 * 4
    t = torch.from_numpy(a)
    del a
    gc.collect()
    assert pool.stats()["live_bytes"] == live
    b = pool.empty((16, 16), np.float32)   # must not get t's buffer
    b[:] = 5.0
    assert float(t.sum()) == 3.0 * 16 * 16
    del t, b
    gc.collect()
    assert pool.stats()["live_bytes"] == 0


# ---------------------------------------------------------------------------
# recordio: native and Python routes, and the JAX package
# ---------------------------------------------------------------------------
def _records():
    rng = np.random.RandomState(0)
    recs = [bytes(rng.bytes(int(rng.randint(1, 512)))) for _ in range(100)]
    recs.append(b"\x0a\x23\xd7\xce" * 8)  # a payload holding the magic
    return recs


@pytest.mark.parametrize("writer_native,reader_native",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_recordio_native_python_compat(tmp_path, route, writer_native,
                                       reader_native):
    recs = _records()
    path = str(tmp_path / "t.rec")
    route(writer_native)
    w = recordio.MXRecordIO(path, "w")
    assert (w._nat is not None) == writer_native
    for r in recs:
        w.write(r)
    w.close()
    route(reader_native)
    r = recordio.MXRecordIO(path, "r")
    assert (r._nat is not None) == reader_native
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    r.close()
    assert got == recs


def test_recordio_split_record_reassembly(tmp_path, route):
    """cflag 1/3 chunked records (dmlc splits payloads at embedded magic
    words) reassemble identically on both routes."""
    import struct

    magic = 0xCED7230A
    path = str(tmp_path / "split.rec")
    with open(path, "wb") as f:
        def chunk(cflag, payload):
            f.write(struct.pack("<II", magic, (cflag << 29) | len(payload)))
            f.write(payload)
            f.write(b"\0" * ((4 - len(payload) % 4) % 4))
        chunk(1, b"AB")
        chunk(3, b"CD")
        chunk(0, b"plain")
    want = b"AB" + struct.pack("<I", magic) + b"CD"
    for native in (False, True):
        route(native)
        r = recordio.MXRecordIO(path, "r")
        assert r.read() == want
        assert r.read() == b"plain"
        assert r.read() is None
        r.close()


def test_indexed_recordio_native(tmp_path):
    path = str(tmp_path / "x.rec")
    idxp = str(tmp_path / "x.idx")
    recs = [os.urandom(100 + i) for i in range(20)]
    w = recordio.MXIndexedRecordIO(idxp, path, "w")
    assert w._nat is not None
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    r = recordio.MXIndexedRecordIO(idxp, path, "r")
    assert r._nat is not None
    assert r.read_idx(13) == recs[13]
    assert r.read_idx(0) == recs[0]
    assert r.read_idx(19) == recs[19]
    r.close()


def test_records_cross_packages_bit_for_bit(tmp_path):
    assert jnative.get_lib() is not None, jnative.last_error()
    recs = _records()
    files = {}
    for pkg, mod in (("jax", jrecordio), ("port", recordio)):
        path, idxp = str(tmp_path / (pkg + ".rec")), str(tmp_path /
                                                        (pkg + ".idx"))
        w = mod.MXIndexedRecordIO(idxp, path, "w")
        assert w._nat is not None
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
        files[pkg] = (path, idxp)
    for a, b in zip(*files.values()):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for writer, reader_mod in (("jax", recordio), ("port", jrecordio)):
        path, idxp = files[writer]
        r = reader_mod.MXIndexedRecordIO(idxp, path, "r")
        assert r._nat is not None
        assert [r.read_idx(k) for k in reversed(r.keys)] == recs[::-1]
        r.close()


# ---------------------------------------------------------------------------
# processes: opting out, building at once
# ---------------------------------------------------------------------------
def _start(code, env, *args):
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return out, err


OPT_OUT = """
import logging, sys
logging.basicConfig(level=logging.WARNING)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native, recordio
assert _native.get_lib() is None
assert type(mx.engine.get()).__name__ == "NaiveEngine"
w = recordio.MXRecordIO(sys.argv[1], "w")
assert w._nat is None and w.handle is not None
w.write(b"x")
w.close()
assert mx.libinfo.features()["NATIVE_RUNTIME"] is False
print("OPT_OUT_OK")
"""


def test_opting_out_gives_python_route_and_no_warning(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_TPU_NO_NATIVE="1")
    out, err = _finish(_start(OPT_OUT, env, str(tmp_path / "o.rec")), 120)
    assert "OPT_OUT_OK" in out
    assert "WARNING" not in err and "unavailable" not in err, err[-2000:]


BUILD = """
import ctypes, sys, types
# the package's modules but _native and base stay unloaded (start-up time)
pkg = types.ModuleType("mxnet_tpu_torch")
pkg.__path__ = [sys.argv[2]]
sys.modules["mxnet_tpu_torch"] = pkg
from mxnet_tpu_torch import _native
path = _native.build(build_dir=sys.argv[1])
lib = _native._declare(ctypes.CDLL(path))
pool = lib.MXTStoragePoolCreate(1 << 16)
lib.MXTStoragePoolFree(pool)
print(path)
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    build_dir = str(tmp_path / "fresh")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [_start(BUILD, env, build_dir,
                    os.path.join(ROOT, "mxnet_tpu_torch")) for _ in range(2)]
    paths = [_finish(p, 180)[0].strip() for p in procs]
    assert paths[0] == paths[1] == _native._lib_path(build_dir)
    assert os.listdir(build_dir) == [os.path.basename(paths[0])]
