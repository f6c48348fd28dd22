"""The port's parameter-server tier on one host
(``mxnet_tpu_torch/kvstore_server.py``) against the JAX package, on the
CPU: every server is built with ``device="cpu"``.

The single-host scenarios of ``tests/test_kvstore_server.py`` (sum
without an optimizer, the server-side optimizer against the local
updater, concurrent workers, ``create('dist_async')``, ``Module.fit``
through the servers and with a store instance, error replies,
first-writer-wins ``set_optimizer``, optimizer-state files, the
dense-backed ``row_sparse_pull``, the hostile ``load_opt`` blob, the
restricted unpickler, barrier timeouts and names, the scheduler and
multipliers on the wire, key sharding over two servers, ``opt_config``,
the claimed-set dedupe) and the pipeline scenarios of
``tests/test_kvstore_async.py`` that need no fault injection (the 2-bit
wire, compression-parameter validation, the out-of-band frames, sender
priority and coalescing, one pull frame a server, the barrier draining
the pipeline, the compressed push against the local simulation, comms
counters, the synchronous client, push after close, the close warning,
the pipeline knob). Values are held against the JAX package's client and
servers (or its updater) on the same seeded inputs.

The wire across packages: the port's client drives the JAX package's
servers and the JAX package's client drives the port's, through init,
dense and row pushes under server-side momentum SGD, and pulls: the tables
equal the all-port and all-JAX runs.

Every test body and fixture teardown runs under a deadline (``bounded``),
so a hang fails the test instead of eating the suite's clock; servers
bind ``127.0.0.1:0``.

Tolerance: fp32, rtol 1e-4 and atol 1e-5; counts, routing and bytes a
server exact.
"""
import io
import os
import pickle
import socket
import threading
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import kvstore_server as jks
from mxnet_tpu_torch import kvstore_server as tks
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore import (two_bit_dequantize, two_bit_quantize,
                                     validate_compression_params)
from mxnet_tpu_torch.tracker import _recv_msg, _send_msg

from torch_kvstore_helpers import _close, _stop, _within, bounded

def _server(pkg="port", **kw):
    if pkg == "port":
        srv = tks.KVStoreServer(device="cpu", **kw)
    else:
        srv = jks.KVStoreServer(**kw)
    srv.serve_in_background()
    return srv


@pytest.fixture
def server():
    srv = _server(num_workers=2)
    yield srv
    _stop(srv)


@pytest.fixture
def server1():
    srv = _server(num_workers=1)
    yield srv
    _stop(srv)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# the server-side optimizer and the store
# ---------------------------------------------------------------------------
@bounded
def test_push_pull_default_sum(server):
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((3,), np.float32))
    kv.push("w", np.array([1.0, 2.0, 3.0], np.float32))
    kv.push("w", tmx.nd.ones((3,)))
    out = np.empty((3,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, [2.0, 3.0, 4.0])
    assert all(d.type == "cpu" for d in server.stored_devices().values())
    kv.close()


@bounded
def test_server_side_optimizer_matches_local_sgd():
    """Server-applied SGD (and momentum, and Adam) equals the JAX
    package's local updater on the same sequence."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(4)]
    for key, (name, kw) in {"0": ("sgd", dict(learning_rate=0.1)),
                            "1": ("sgd", dict(learning_rate=0.1,
                                              momentum=0.9)),
                            "2": ("adam", dict(learning_rate=0.01,
                                               wd=0.01))}.items():
        srv = _server()
        kv = tks.ServerKVStore(srv.addr)
        kv.init(key, w0)
        kv.set_optimizer(name, **kw)
        for g in grads:
            kv.push(key, g)
        got = np.empty_like(w0)
        kv.pull(key, out=got)
        upd = jmx.optimizer.get_updater(jmx.optimizer.create(name, **kw))
        w = jmx.nd.array(w0)
        for g in grads:
            upd(key, jmx.nd.array(g), w)
        _close(got, w.asnumpy(), name)
        _stop(kv, srv)


@bounded
def test_async_pushes_from_two_workers(server):
    kv0 = tks.ServerKVStore(server.addr)
    kv0.init("w", np.zeros((8,), np.float32))
    errors = []

    def worker(seed):
        try:
            kv = tks.ServerKVStore(server.addr)
            rng = np.random.RandomState(seed)
            for _ in range(20):
                kv.push("w", rng.rand(8).astype(np.float32))
            kv.barrier()
            kv.close()
        except BaseException as e:  # noqa: B902 - reported below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(s,), daemon=True)
          for s in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    expect = np.zeros((8,), np.float32)
    for s in (1, 2):
        rng = np.random.RandomState(s)
        for _ in range(20):
            expect += rng.rand(8).astype(np.float32)
    got = np.empty((8,), np.float32)
    kv0.pull("w", out=got)
    _close(got, expect)
    assert server._pushes_applied == 40
    kv0.close()


@bounded
def test_factory_routes_dist_async_to_server(server, monkeypatch):
    monkeypatch.setenv("MXNET_PS_SERVER_URI", server.addr)
    kv = tmx.kv.create("dist_async")
    assert isinstance(kv, tks.ServerKVStore) and kv.type == "dist_async"
    kv.init("k", np.ones((2,), np.float32))
    out = np.empty((2,), np.float32)
    kv.pull("k", out=out)
    np.testing.assert_array_equal(out, 1.0)
    kv.close()
    monkeypatch.delenv("MXNET_PS_SERVER_URI")
    # serverless: the collective store, with its warning
    with pytest.warns(UserWarning, match="synchronous semantics"):
        kv = tmx.kv.create("dist_async")
    assert isinstance(kv, tmx.kv.DistKVStore) and kv.type == "dist_async"
    kv.set_barrier_before_exit(False)
    # the scheduler topology: dist_async discovers the servers through the
    # tracker's rendezvous, dist_sync is refused with the JAX message
    from mxnet_tpu_torch import tracker

    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9")
    monkeypatch.setenv("DMLC_NUM_SERVER", "1")
    monkeypatch.setattr(tracker, "discover_server_uris",
                        lambda timeout=60.0: [server.addr])
    monkeypatch.setattr(tracker, "worker_client", lambda: None)
    kv = tmx.kv.create("dist_async")
    assert isinstance(kv, tks.ServerKVStore) and kv._uris == [server.addr]
    kv.close()
    for mx in (tmx, jmx):
        with pytest.raises(mx.MXNetError, match="scheduler topology"):
            mx.kv.create("dist_sync")


def _mlp_fit(mx, kvstore, x, y, params, epochs, batch):
    it = mx.io.NDArrayIter({"data": x}, {"softmax_label": y},
                           batch_size=batch, shuffle=False)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                num_hidden=32)
    net = mx.sym.Activation(net, name="relu1", act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=5)
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            kvstore=kvstore, eval_metric="acc", num_epoch=epochs)
    it.reset()
    acc = dict(mod.score(it, mx.metric.create("acc")))["accuracy"]
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, acc


def _mlp_case(n=600):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 20).astype(np.float32)
    w = rng.randn(20, 5).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    params = {"fc1_weight": rng.randn(32, 20).astype(np.float32) * 0.2,
              "fc1_bias": np.zeros(32, np.float32),
              "fc2_weight": rng.randn(5, 32).astype(np.float32) * 0.2,
              "fc2_bias": np.zeros(5, np.float32)}
    return x, y, params


@bounded
def test_module_fit_through_server(monkeypatch):
    """``Module.fit(kvstore='dist_async')`` with a URI: every update goes
    through the servers' optimizer (no fused step), the module learns the
    task, its parameters equal the JAX package's run through its own
    servers, and the weights the servers hold equal the module's."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    x, y, params = _mlp_case()
    runs = {}
    for pkg, mx in (("port", tmx), ("jax", jmx)):
        srv = _server(pkg, num_workers=1)
        monkeypatch.setenv("MXNET_PS_SERVER_URI", srv.addr)
        mod, arg, acc = _mlp_fit(mx, "dist_async", x, y, params, 8, 100)
        assert mod._update_on_kvstore and mod._fused is None
        assert type(mod._kvstore).__name__ == "ServerKVStore"
        held = {}
        for k in arg:
            held[k] = np.empty_like(arg[k])
            mod._kvstore.pull(k, out=held[k])
        runs[pkg] = (arg, acc, held)
        _stop(mod._kvstore, srv)
    (targ, tacc, theld), (jarg, jacc, _jheld) = runs["port"], runs["jax"]
    assert tacc > 0.9 and jacc > 0.9, (tacc, jacc)
    for k in targ:
        _close(targ[k], jarg[k], k)
        np.testing.assert_array_equal(theld[k], targ[k])


@bounded
def test_preconstructed_instance_through_module_fit(server, monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    from mxnet_tpu_torch.model import _create_kvstore

    kv = tks.ServerKVStore(server.addr)
    got, update_on_kv = _create_kvstore(kv, 1, {})
    assert got is kv and update_on_kv
    x, y, params = _mlp_case(200)
    mod, _arg, acc = _mlp_fit(tmx, kv, x, y, params, 6, 50)
    assert mod._kvstore is kv and mod._update_on_kvstore
    assert acc > 0.8, acc
    kv.close()


@bounded
def test_bad_requests_get_error_replies(server):
    kv = tks.ServerKVStore(server.addr)
    out = np.empty((2,), np.float32)
    with pytest.raises(MXNetError, match="pull before init"):
        kv.pull("missing", out=out)
    with pytest.raises(MXNetError, match="unknown optimizer"):
        kv.set_optimizer("not_an_optimizer")
    with pytest.raises(MXNetError, match="rollback.*MXNET_CHECKPOINT_DIR"):
        kv._rpc("rollback", meta={})
    kv.init("w", np.ones((2,), np.float32))
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 1.0)
    kv.close()


@bounded
def test_set_optimizer_first_writer_wins(server):
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
    kv.push("w", np.ones((2,), np.float32))
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
    kv.push("w", np.ones((2,), np.float32))
    got = np.empty((2,), np.float32)
    kv.pull("w", out=got)
    upd = jmx.optimizer.get_updater(
        jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
    w = jmx.nd.zeros((2,))
    for _ in range(2):
        upd("w", jmx.nd.ones((2,)), w)
    _close(got, w.asnumpy())
    with pytest.raises(MXNetError, match="conflicting"):
        kv.set_optimizer("sgd", learning_rate=0.5, momentum=0.5)
    kv.close()


@bounded
def test_optimizer_state_roundtrip(server, tmp_path):
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((3,), np.float32))
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
    kv.push("w", np.ones((3,), np.float32))
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    w_at_save = np.empty((3,), np.float32)
    kv.pull("w", out=w_at_save)
    kv.push("w", np.ones((3,), np.float32))
    after_two = np.empty((3,), np.float32)
    kv.pull("w", out=after_two)
    kv.load_optimizer_states(fname)
    kv.push("w", np.ones((3,), np.float32))
    replay = np.empty((3,), np.float32)
    kv.pull("w", out=replay)
    _close(replay - after_two, after_two - w_at_save)
    # the file is the JAX package's states format
    with open(fname, "rb") as f:
        states = pickle.loads(f.read())
    _close(states["w"], np.full((3,), -0.1, np.float32))
    kv.close()


@bounded
def test_row_sparse_pull_dense_backed(server):
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = {}
    for pkg, mx, ks in (("port", tmx, tks), ("jax", jmx, jks)):
        srv = _server(pkg)
        kv = ks.ServerKVStore(srv.addr)
        kv.init("emb", w)
        t = mx.nd.zeros((4, 3))
        kv.row_sparse_pull("emb", out=t, row_ids=mx.nd.array([2, 0, 2]))
        rsp = mx.nd.sparse.zeros("row_sparse", (4, 3))
        kv.row_sparse_pull("emb", out=rsp, row_ids=mx.nd.array([3, 1]))
        got[pkg] = (t.asnumpy(), rsp.indices.asnumpy(), rsp.asnumpy())
        assert kv.rank == 0
        _stop(kv, srv)
    t, j = got["port"], got["jax"]
    np.testing.assert_array_equal(t[0], j[0])
    assert t[0][[1, 3]].sum() == 0 and (t[0][2] == w[2]).all()
    assert t[1].tolist() == j[1].tolist() == [1, 3]
    np.testing.assert_array_equal(t[2], j[2])


@bounded
def test_load_opt_refuses_hostile_pickle(server, tmp_path):
    marker = tmp_path / "owned"

    class Evil:
        def __reduce__(self):
            return (os.mkdir, (str(marker),))

    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
    with pytest.raises(MXNetError, match="never unpickles"):
        kv._rpc("load_opt", wire=pickle.dumps({"0": Evil()}))
    assert not marker.exists()
    with pytest.raises(MXNetError, match="wire tag"):
        kv._rpc("load_opt", wire=[("0", ("exploit", b"x"))])
    kv.push("w", np.ones((2,), np.float32))
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    kv.load_optimizer_states(fname)
    out = np.empty((2,), np.float32)
    kv.pull("w", out=out)
    assert np.all(np.isfinite(out))
    kv.close()


@bounded
def test_row_sparse_pull_out_of_range_raises(server):
    kv = tks.ServerKVStore(server.addr)
    kv.init("emb", np.arange(12, dtype=np.float32).reshape(4, 3))
    t = tmx.nd.zeros((4, 3))
    for bad in ([1, 7], [-1, 2]):
        with pytest.raises(MXNetError, match="out of range"):
            kv.row_sparse_pull("emb", out=t, row_ids=tmx.nd.array(bad))
    kv.row_sparse_pull("emb", out=t, row_ids=tmx.nd.array([3]))
    np.testing.assert_array_equal(t.asnumpy()[3], [9.0, 10.0, 11.0])
    kv.close()


@bounded
def test_row_sparse_pull_broadcast_stays_per_key(server):
    kv = tks.ServerKVStore(server.addr)
    wa = np.arange(6, dtype=np.float32).reshape(2, 3)
    kv.init(["a", "b"], [wa, wa + 100.0])
    outs_a = [tmx.nd.zeros((2, 3)) for _ in range(2)]
    outs_b = [tmx.nd.zeros((2, 3)) for _ in range(3)]
    kv.row_sparse_pull(["a", "b"], out=[outs_a, outs_b],
                       row_ids=[tmx.nd.array([1])])
    for t in outs_a:
        np.testing.assert_array_equal(t.asnumpy()[1], wa[1])
    for t in outs_b:
        np.testing.assert_array_equal(t.asnumpy()[1], wa[1] + 100.0)
    kv.close()


def test_wire_protocol_refuses_objects():
    evil = pickle.dumps(np.float32(1.0))
    with pytest.raises(pickle.UnpicklingError):
        tks._SafeUnpickler(io.BytesIO(evil)).load()
    msg = ("push", "k", None, ("float32", (1,), b"\0\0\0\0"))
    ok = tks._SafeUnpickler(io.BytesIO(tks._pack(msg))).load()
    assert ok == msg
    # the frame bytes are the JAX package's
    assert tks._pack(msg) == jks._pack(msg)


@bounded
def test_barrier_timeout_raises_instead_of_spinning():
    srv = _server(num_workers=2, barrier_timeout=1.5)
    try:
        kv = tks.ServerKVStore(srv.addr)
        t0 = time.monotonic()
        with pytest.raises(MXNetError, match="barrier timed out"):
            kv.barrier()
        assert time.monotonic() - t0 < 10
        kv2 = tks.ServerKVStore(srv.addr)
        done = []
        ts = [threading.Thread(target=lambda c=c: (c.barrier(),
                                                   done.append(1)),
                               daemon=True) for c in (kv, kv2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert len(done) == 2
        _stop(kv, kv2)
    finally:
        _stop(srv)


@bounded
def test_set_optimizer_serializes_scheduler_and_mults(server):
    """The scheduler, lr_mult and idx2name cross as plain data and steer
    the servers' updater as the JAX package's local updater."""
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5,
                                             base_lr=1.0)
    opt = tmx.optimizer.create("sgd", learning_rate=1.0,
                               lr_scheduler=sched, param_idx2name={0: "w"})
    opt.set_lr_mult({"w": 0.5})
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.set_optimizer(opt)
    for _ in range(3):
        kv.push("w", np.ones((2,), np.float32))
    got = np.empty((2,), np.float32)
    kv.pull("w", out=got)
    ref = jmx.optimizer.create(
        "sgd", learning_rate=1.0,
        lr_scheduler=jmx.lr_scheduler.FactorScheduler(step=1, factor=0.5,
                                                      base_lr=1.0),
        param_idx2name={0: "w"})
    ref.set_lr_mult({"w": 0.5})
    upd = jmx.optimizer.get_updater(ref)
    w = jmx.nd.zeros((2,))
    for _ in range(3):
        upd("w", jmx.nd.ones((2,)), w)
    _close(got, w.asnumpy())
    assert not np.allclose(got, -3.0)
    kv.close()


@bounded
def test_set_optimizer_warns_on_unrepresentable_config(server):
    class MyFancySched(tmx.lr_scheduler.LRScheduler):
        def __call__(self, num_update):
            return self.base_lr

    class FakeParam:
        lr_mult = 2.0
        wd_mult = 1.0

    opt = tmx.optimizer.create("sgd", learning_rate=0.1,
                               lr_scheduler=MyFancySched())
    opt.param_dict = {"w": FakeParam()}
    kv = tks.ServerKVStore(server.addr)
    with pytest.warns(UserWarning, match="DROPPING.*lr_scheduler"):
        kv.set_optimizer(opt)
    kv.close()


@bounded
def test_sharded_servers_split_keys_and_merge_opt_state(tmp_path):
    """Two servers: keys shard by crc32 exactly as the JAX client routes
    them; barriers visit both; the states file merges and re-splits."""
    srv_a, srv_b = _server(num_workers=1), _server(num_workers=1)
    try:
        kv = tks.ServerKVStore([srv_a.addr, srv_b.addr])
        keys = ["fc%d_weight" % i for i in range(8)]
        for i, k in enumerate(keys):
            kv.init(k, np.full((3,), float(i), np.float32))
        kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
        for k in keys:
            kv.push(k, np.ones((3,), np.float32))
        for i, k in enumerate(keys):
            out = np.empty((3,), np.float32)
            kv.pull(k, out=out)
            _close(out, np.full((3,), float(i) - 0.1))
        assert set(srv_a._store) == {k for k in keys
                                     if jks.shard_key(k, 2) == 0}
        assert 0 < len(srv_a._store) < len(keys)
        assert len(srv_a._store) + len(srv_b._store) == len(keys)
        kv.barrier()
        fname = str(tmp_path / "sharded.states")
        kv.save_optimizer_states(fname)
        kv.load_optimizer_states(fname)
        kv.push(keys[0], np.ones((3,), np.float32))
        kv.stop_server()
        kv.close()
    finally:
        _stop(srv_a, srv_b)


@bounded
def test_opt_config_roundtrip(server):
    kv = tks.ServerKVStore(server.addr)
    assert kv.get_optimizer_config() is None
    kv.set_optimizer("sgd", learning_rate=0.25, momentum=0.5)
    name, kwargs, _extras = kv.get_optimizer_config()
    assert name == "sgd"
    assert kwargs["learning_rate"] == 0.25 and kwargs["momentum"] == 0.5
    kv.close()


@bounded
def test_named_barriers_do_not_pair_across_names():
    srv = _server(num_workers=2, barrier_timeout=15.0)
    try:
        a, b = tks.ServerKVStore(srv.addr), tks.ServerKVStore(srv.addr)
        t = threading.Thread(target=lambda: a.barrier("phase-b"),
                             daemon=True)
        t.start()
        time.sleep(0.3)
        t2 = threading.Thread(target=lambda: b.barrier("phase-a"),
                              daemon=True)
        t2.start()
        time.sleep(0.5)
        assert t.is_alive() and t2.is_alive()
        c = tks.ServerKVStore(srv.addr)
        c.barrier("phase-b")
        t.join(timeout=5)
        assert not t.is_alive()
        c.barrier("phase-a")
        t2.join(timeout=5)
        assert not t2.is_alive()
        _stop(a, b, c)
    finally:
        _stop(srv)


@bounded
def test_push_dedupe_is_a_claimed_set_not_a_high_water_mark(server1):
    srv = server1
    assert srv._claim_push({"cid": "c1", "seq": 6})
    assert srv._claim_push({"cid": "c1", "seq": 5})
    assert not srv._claim_push({"cid": "c1", "seq": 5})
    assert not srv._claim_push({"cid": "c1", "seq": 6})
    assert srv._claim_push({"cid": "c2", "seq": 6})
    srv._release_push({"cid": "c1", "seq": 5})
    assert srv._claim_push({"cid": "c1", "seq": 5})
    kv = tks.ServerKVStore(srv.addr)
    with pytest.raises(MXNetError, match="push before init"):
        kv._rpc_idx(0, "push", "w", {"cid": kv._client_id, "seq": 0},
                    ("float32", (2,), b"\0" * 8))
    kv.init("w", np.zeros((2,), np.float32))
    for _ in range(2):   # the second is a retry of the same seqno
        kv._rpc_idx(0, "push", "w", {"cid": kv._client_id, "seq": 0},
                    ("float32", (2,), np.ones((2,), np.float32).tobytes()))
    out = np.empty((2,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 1.0)
    assert srv._pushes_applied == 1
    kv.close()


def test_item10_modes_raise_by_name(server1, monkeypatch, tmp_path):
    """Item 10's recovery half is ported (restore, rollback, rediscovery,
    elastic barriers, the chaos server and rpc hooks: each builds or
    answers here, its behaviour is held below and in
    tests/test_torch_self_healing.py), and so is ZeRO value sharding over
    the servers, which raised by name before (the ``test_zero_server_*``
    cases hold what it does)."""
    srv = server1
    with pytest.raises(AttributeError):
        srv.restore_from_checkpoint(None)          # it reads the handle
    kv = tks.ServerKVStore(srv.addr)
    monkeypatch.delenv("MXNET_CHECKPOINT_DIR", raising=False)
    with pytest.raises(MXNetError, match="rollback.*MXNET_CHECKPOINT_DIR"):
        kv.rollback_servers(lr_scale=0.5)
    kv.close()

    class _Tracker:
        rank = 3

        def num_dead_node(self):
            return 1

    kv = tks.ServerKVStore(srv.addr, tracker_client=_Tracker())
    assert (kv.rank, kv.num_dead_node()) == (3, 1)
    kv.close()
    for elastic in (True, None):
        if elastic is None:
            monkeypatch.setenv("MXNET_MAX_RESTARTS", "2")
        other = tks.KVStoreServer(device="cpu", elastic=elastic)
        assert other._elastic
        other.shutdown()
    monkeypatch.delenv("MXNET_MAX_RESTARTS")
    monkeypatch.setenv("MXNET_TPU_ZERO_SERVER", "1")
    kv = tks.ServerKVStore([srv.addr, srv.addr])
    assert kv._zero and kv._zero_min == 1024
    kv.close()
    monkeypatch.delenv("MXNET_TPU_ZERO_SERVER")
    from mxnet_tpu_torch import chaos, tracker

    monkeypatch.setenv("MXNET_FAULT_SPEC", "rpc:drop@op=push,n=1")
    chaos.reset_engine()
    try:
        tks.ServerKVStore(srv.addr).close()
        assert [r.target for r in chaos.engine().rules] == ["rpc"]
    finally:
        monkeypatch.delenv("MXNET_FAULT_SPEC")
        chaos.reset_engine()
    # the tracker's client is ported: with no scheduler listening it
    # fails its bounded connect, typed
    with pytest.raises(tracker.TrackerError, match="could not connect"):
        tracker.TrackerClient("127.0.0.1:1", "worker", connect_deadline=0.3)


def test_server_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        srv = tks.KVStoreServer()
        assert srv.device.type == "cuda"
        srv.shutdown()
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            tks.KVStoreServer()


# ---------------------------------------------------------------------------
# the wire across packages
# ---------------------------------------------------------------------------
def _wire_run(ks, addrs):
    """init, dense and row pushes under server-side momentum SGD, pulls:
    the tables as numpy."""
    rng = np.random.RandomState(4)
    kv = ks.ServerKVStore(addrs)
    keys = ["w%d" % i for i in range(4)]
    for i, k in enumerate(keys):
        kv.init(k, rng.randn(3, 5).astype(np.float32))
    # an embedding sub-table lives on server s % n (here 0), whatever
    # its key's hash
    kv._rpc_idx(0, "init", "e@embshard0", None,
                ks._arr_to_wire(rng.randn(10, 3).astype(np.float32)))
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9, wd=0.01)
    for step in range(3):
        for k in keys:
            kv.push(k, rng.randn(3, 5).astype(np.float32))
        ids = np.array([1, 7, 1, 4]) + step
        kv.row_push(0, "e@embshard0", ids,
                    rng.randn(4, 3).astype(np.float32))
    out = {}
    for k in keys:
        out[k] = np.empty((3, 5), np.float32)
        kv.pull(k, out=out[k])
    out["rows"] = kv.row_pull(0, "e@embshard0", [8, 1, 0, 5])
    out["e"] = ks._arr_from_wire(kv._rpc_idx(0, "pull", "e@embshard0"))
    out["mem"] = kv.server_memory()
    kv.close()
    return out


@pytest.mark.parametrize("client,servers", [("port", "jax"),
                                            ("jax", "port")])
@bounded
def test_wire_across_packages(client, servers):
    """Each package's client drives the other's two servers to the tables
    (and bytes a server) of the all-port and all-JAX runs."""
    runs = {}
    for c, s in ((client, servers), ("port", "port"), ("jax", "jax")):
        srvs = [_server(s, num_workers=1) for _ in range(2)]
        try:
            runs[(c, s)] = _wire_run(tks if c == "port" else jks,
                                         [x.addr for x in srvs])
        finally:
            _stop(*srvs)
    mixed = runs[(client, servers)]
    for ref in (runs[("port", "port")], runs[("jax", "jax")]):
        for k in mixed:
            if k == "mem":
                assert mixed[k] == ref[k]
            else:
                _close(mixed[k], ref[k], k)
    assert sum(m["keys"] for m in mixed["mem"]) == 5
    assert sum(m["embed_store_bytes"] for m in mixed["mem"]) == 10 * 3 * 4


# ---------------------------------------------------------------------------
# the 2-bit wire
# ---------------------------------------------------------------------------
def expected_2bit(arr, residual, threshold):
    a = arr + residual
    decompr = np.zeros_like(arr)
    decompr[a >= threshold] = threshold
    decompr[a <= -threshold] = -threshold
    return decompr, a - decompr


def test_two_bit_pack_matches_jax_bit_for_bit():
    from mxnet_tpu.kvstore import two_bit_quantize as jquant

    rng = np.random.RandomState(0)
    res_t = res_j = None
    for shape, thr in (((8, 31), 0.5), ((5, 7), 0.7), ((3,), 0.25)):
        g = rng.randn(*shape).astype(np.float32)
        pt, res_t = two_bit_quantize(g, res_t if res_t is not None
                                     and res_t.shape == shape else None, thr)
        pj, res_j = jquant(g, res_j if res_j is not None
                           and res_j.shape == shape else None, thr)
        assert pt.dtype == np.uint8 and pt.size == -(-g.size // 4)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(res_t, res_j)
        exp, _ = expected_2bit(g, np.zeros_like(g), thr)
        np.testing.assert_array_equal(
            two_bit_dequantize(pt, g.shape, "float32", thr), exp)


def test_two_bit_error_feedback_residual_converges():
    rng = np.random.RandomState(3)
    res = None
    total_q = np.zeros((64,), np.float32)
    total_g = np.zeros((64,), np.float32)
    for _ in range(50):
        g = rng.uniform(-0.4, 0.4, (64,)).astype(np.float32)
        packed, res = two_bit_quantize(g, res, 0.5)
        total_q += two_bit_dequantize(packed, g.shape, "float32", 0.5)
        total_g += g
    assert np.max(np.abs(total_q - total_g)) <= 0.5 + 1e-5


def test_two_bit_roundtrip_matches_reference_sequence():
    rng = np.random.RandomState(1)
    res_ref = np.zeros((5, 7), np.float32)
    res = None
    for _ in range(4):
        g = rng.uniform(-1.5, 1.5, (5, 7)).astype(np.float32)
        exp, res_ref = expected_2bit(g, res_ref, 0.7)
        packed, res = two_bit_quantize(g, res, 0.7)
        np.testing.assert_allclose(
            two_bit_dequantize(packed, g.shape, "float32", 0.7), exp,
            atol=1e-7)
        np.testing.assert_allclose(res, res_ref, atol=1e-6)


def test_grad_wire_tags_compressed_payloads():
    g = np.random.RandomState(2).randn(40).astype(np.float32)
    packed, _ = two_bit_quantize(g, None, 0.25)
    wire = tks._grad_to_wire(g, (packed, 0.25))
    assert wire[0] == "2bit"
    exp, _ = expected_2bit(g, np.zeros_like(g), 0.25)
    np.testing.assert_array_equal(tks._grad_from_wire(wire), exp)
    np.testing.assert_array_equal(jks._grad_from_wire(wire), exp)
    np.testing.assert_array_equal(
        tks._grad_from_wire(tks._grad_to_wire(g)), g)


@pytest.mark.parametrize("bad", [0.0, -1.0, float("inf"), float("nan"),
                                 "0.5", None, True])
def test_compression_threshold_validated(bad):
    with pytest.raises(MXNetError, match="threshold"):
        validate_compression_params({"type": "2bit", "threshold": bad})


def test_compression_unknown_keys_rejected_loudly():
    with pytest.raises(MXNetError, match="unknown key.*'thresold'"):
        validate_compression_params({"type": "2bit", "thresold": 0.5})
    with pytest.raises(MXNetError, match="expects a dict"):
        validate_compression_params("2bit")
    with pytest.raises(MXNetError, match="unknown key"):
        tmx.kv.create("local").set_gradient_compression(
            {"type": "2bit", "treshold": 1})
    # valid params on the in-process store: the default threshold
    kv = tmx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit"})
    assert kv._compression_params == {"type": "2bit", "threshold": 0.5}
    assert validate_compression_params({"type": "2bit"}) == \
        {"type": "2bit", "threshold": 0.5}


@bounded
def test_server_tier_accepts_compression(server1):
    kv = tks.ServerKVStore(server1.addr)
    with pytest.raises(MXNetError, match="threshold"):
        kv.set_gradient_compression({"type": "2bit", "threshold": -3})
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.close()


@bounded
def test_oob_framing_roundtrip_exact():
    a, b = socket.socketpair()
    try:
        big = np.arange(100000, dtype=np.float32)
        small = np.arange(3, dtype=np.int64)
        msg = ("push", "k", {"seq": 1},
               [tks._arr_to_wire(big, zero_copy=True),
                tks._arr_to_wire(small)])
        got = {}
        t = threading.Thread(
            target=lambda: got.setdefault("msg", _recv_msg(a)), daemon=True)
        t.start()
        sent = _send_msg(b, msg)
        t.join(timeout=10)
        assert sent > big.nbytes
        op, key, meta, (wbig, wsmall) = got["msg"]
        assert (op, key, meta) == ("push", "k", {"seq": 1})
        gb = tks._arr_from_wire(wbig)
        np.testing.assert_array_equal(gb, big)
        assert gb.flags.writeable
        np.testing.assert_array_equal(tks._arr_from_wire(wsmall), small)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the sender pipeline
# ---------------------------------------------------------------------------
def _entry(key, nbytes=8):
    return {"key": key, "meta": {}, "wire": None, "nbytes": nbytes,
            "future": tks._PushFuture()}


def test_sender_drains_in_priority_order():
    sender = tks._ShardSender(store=None, idx=0, start=False)
    for key, prio in (("low", -5), ("mid", 0), ("hi", 3), ("mid2", 0)):
        sender.enqueue(_entry(key), priority=prio)
    batch = sender._next_batch_locked()
    assert [e["key"] for e in batch] == ["hi", "mid", "mid2", "low"]


def test_sender_coalesces_up_to_byte_and_key_budget():
    sender = tks._ShardSender(store=None, idx=0, max_keys=3, max_bytes=100,
                              start=False)
    for i in range(5):
        sender.enqueue(_entry("k%d" % i, nbytes=8))
    assert len(sender._next_batch_locked()) == 3
    sender2 = tks._ShardSender(store=None, idx=0, max_keys=16,
                               max_bytes=100, start=False)
    for i in range(5):
        sender2.enqueue(_entry("k%d" % i, nbytes=60))
    assert len(sender2._next_batch_locked()) == 2


@bounded
def test_multi_key_frames_reduce_rpc_count(server1):
    profiler.comm_reset()
    kv = tks.ServerKVStore(server1.addr)
    keys = ["w%02d" % i for i in range(40)]
    for k in keys:
        kv.init(k, np.zeros((16,), np.float32))
    for i, k in enumerate(keys):
        kv.push(k, np.full((16,), float(i), np.float32), priority=-i)
    kv.wait_outstanding()
    assert server1._pushes_applied == len(keys)
    stats = profiler.comm_stats()
    assert 0 < stats["push"]["count"] < len(keys), stats["push"]
    for i, k in enumerate(keys):
        out = np.empty((16,), np.float32)
        kv.pull(k, out=out)
        np.testing.assert_array_equal(out, float(i))
    kv.close()


@bounded
def test_batched_pull_spans_shards():
    srv_a, srv_b = _server(num_workers=1), _server(num_workers=1)
    try:
        kv = tks.ServerKVStore([srv_a.addr, srv_b.addr])
        keys = ["fc%d_weight" % i for i in range(8)]
        for i, k in enumerate(keys):
            kv.init(k, np.full((5,), float(i), np.float32))
        assert len(srv_a._store) and len(srv_b._store)
        outs = [np.empty((5,), np.float32) for _ in keys]
        profiler.comm_reset()
        kv.pull(keys, outs)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, float(i))
        assert profiler.comm_stats()["pull"]["count"] == 2
        kv.stop_server()
        kv.close()
    finally:
        _stop(srv_a, srv_b)


@bounded
def test_barrier_drains_the_pipeline(server1):
    kv = tks.ServerKVStore(server1.addr)
    kv.init("w", np.zeros((2048,), np.float32))
    for _ in range(50):
        kv.push("w", np.ones((2048,), np.float32))
    kv.barrier()
    assert server1._pushes_applied == 50
    kv.close()


@bounded
def test_compressed_push_matches_local_simulation(server1):
    """The 2-bit wire (quantize here, dequantize on the server, server
    SGD) equals the JAX package's updater fed the simulated codes."""
    kv = tks.ServerKVStore(server1.addr)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    w0 = np.zeros((6, 5), np.float32)
    kv.init("w", w0)
    kv.set_optimizer("sgd", learning_rate=0.1)
    rng = np.random.RandomState(7)
    upd = jmx.optimizer.get_updater(
        jmx.optimizer.create("sgd", learning_rate=0.1))
    w_ref = jmx.nd.array(w0)
    res = np.zeros_like(w0)
    for _ in range(5):
        g = rng.uniform(-1.2, 1.2, w0.shape).astype(np.float32)
        kv.push("w", g)
        q, res = expected_2bit(g, res, 0.5)
        upd("w", jmx.nd.array(q), w_ref)
    got = np.empty_like(w0)
    kv.pull("w", out=got)
    _close(got, w_ref.asnumpy())
    kv.close()


@bounded
def test_compressed_push_shrinks_wire_bytes(server1):
    kv = tks.ServerKVStore(server1.addr)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("big", np.zeros((1 << 16,), np.float32))
    profiler.comm_reset()
    g = np.random.RandomState(0).randn(1 << 16).astype(np.float32)
    for _ in range(3):
        kv.push("big", g)
    kv.wait_outstanding()
    push = kv.comm_stats()["push"]
    assert push["raw_bytes"] >= 4 * push["wire_bytes"], push
    assert push["count"] >= 1 and push["seconds"] > 0
    kv.close()


@bounded
def test_comm_stats_counters_present(server1):
    profiler.comm_reset()
    kv = tks.ServerKVStore(server1.addr)
    kv.init("w", np.zeros((4,), np.float32))
    kv.push("w", np.ones((4,), np.float32))
    out = np.empty((4,), np.float32)
    kv.pull("w", out=out)
    stats = kv.comm_stats()
    assert stats["push"]["raw_bytes"] == 16
    assert stats["push"]["wire_bytes"] > 0
    assert stats["pull"]["count"] == 1
    assert "avg_ms" in stats["pull"]
    assert stats["push"]["max_inflight"] >= 1
    kv.comm_stats(reset=True)
    assert kv.comm_stats() == {}
    kv.close()


@bounded
def test_sync_client_mode_still_available(server1):
    kv = tks.ServerKVStore(server1.addr, pipeline=False)
    kv.init("w", np.zeros((4,), np.float32))
    kv.push("w", np.ones((4,), np.float32))
    assert not kv._senders
    assert server1._pushes_applied >= 1
    out = np.empty((4,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 1.0)
    kv.close()


@bounded
def test_push_after_close_errors_instead_of_hanging(server1):
    kv = tks.ServerKVStore(server1.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.push("w", np.ones((2,), np.float32))
    kv.close()
    with pytest.raises(MXNetError, match="stopped"):
        kv.push("w", np.ones((2,), np.float32))
    with pytest.raises(MXNetError, match="stopped"):
        kv.wait_outstanding()


@bounded
def test_push_after_close_fails_fast_on_untouched_shard(server1):
    kv = tks.ServerKVStore(server1.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.close()
    assert not kv._senders
    with pytest.raises(MXNetError, match="stopped"):
        kv.push("w", np.ones((2,), np.float32))
    assert not kv._senders


@bounded
def test_close_warns_on_undelivered_async_failure(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RPC_RETRIES", "0")
    monkeypatch.setenv("MXNET_KVSTORE_RECONNECT_DEADLINE", "0.2")
    srv = _server(num_workers=1)
    kv = tks.ServerKVStore(srv.addr)
    kv.init("w", np.zeros((2,), np.float32))
    srv.shutdown()
    kv.push("w", np.ones((2,), np.float32))
    with pytest.warns(UserWarning, match="undelivered async push"):
        kv.close()
    srv2 = _server(num_workers=1)
    kv2 = tks.ServerKVStore(srv2.addr)
    kv2.init("w", np.zeros((2,), np.float32))
    srv2.shutdown()
    kv2.push("w", np.ones((2,), np.float32))
    with pytest.raises(MXNetError):
        kv2.wait_outstanding()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        kv2.close()


@bounded
def test_pipeline_env_knob_validated(server1, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_PIPELINE", "yes")
    with pytest.raises(MXNetError, match="MXNET_KVSTORE_PIPELINE"):
        tks.ServerKVStore(server1.addr)
    monkeypatch.setenv("MXNET_KVSTORE_PIPELINE", "0")
    kv = tks.ServerKVStore(server1.addr)
    assert not kv._pipeline
    kv.close()


@bounded
@pytest.mark.parametrize("knob,value", [
    ("MXNET_KVSTORE_REDISCOVER_TIMEOUT", "30"),
    ("MXNET_PS_BIND_HOST", "127.0.0.1"),
    ("MXNET_PS_BIND_PORT", "9000"),
    ("MXNET_PS_ADVERTISE_HOST", "10.0.0.1")])
def test_item10_knobs_raise_when_set(server1, monkeypatch, knob, value):
    """The knobs of item 10's parts are registered with the JAX package's
    defaults. Those of the entry point, which raised by name before, are
    read by it (``test_entrypoint_*`` hold what they do): a server and a
    client build with them set. The rediscovery timeout is read by the
    client (and a malformed value raises naming it)."""
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig

    assert tconfig.KNOBS[knob][0] == jconfig.KNOBS[knob][0]
    monkeypatch.setenv(knob, value)
    if knob == "MXNET_KVSTORE_REDISCOVER_TIMEOUT":
        kv = tks.ServerKVStore(server1.addr)
        assert kv._rediscover_timeout == 30.0
        kv.close()
        monkeypatch.setenv(knob, "0")
        with pytest.raises(Exception, match=knob):
            tks.ServerKVStore(server1.addr)
        return
    assert tconfig.get(knob) == value
    tks.KVStoreServer(device="cpu").shutdown()
    tks.ServerKVStore(server1.addr).close()


@bounded
@pytest.mark.parametrize("knob,value", [
    ("MXNET_KVSTORE_RPC_RETRIES", "-1"),
    ("MXNET_KVSTORE_RECONNECT_DEADLINE", "nan"),
    ("MXNET_KVSTORE_COALESCE_KEYS", "x"),
    ("MXNET_KVSTORE_COALESCE_BYTES", "-5"),
    ("MXNET_KVSTORE_BARRIER_TIMEOUT", "0")])
def test_malformed_server_tier_knob_raises_naming_it(server1, monkeypatch,
                                                     knob, value):
    """Each package's client refuses a malformed server-tier knob with
    TrackerError naming it (the port reads it through config's getter)."""
    from mxnet_tpu import tracker as jtracker
    from mxnet_tpu_torch import tracker

    monkeypatch.setenv(knob, value)
    if knob == "MXNET_KVSTORE_BARRIER_TIMEOUT":
        for make, err in ((lambda: tks.KVStoreServer(device="cpu"),
                           tracker.TrackerError),
                          (lambda: jks.KVStoreServer(),
                           jtracker.TrackerError)):
            with pytest.raises(err, match=knob):
                make()
        return
    for client, err in ((tks.ServerKVStore, tracker.TrackerError),
                        (jks.ServerKVStore, jtracker.TrackerError)):
        with pytest.raises(err, match=knob):
            client(server1.addr)


# ---------------------------------------------------------------------------
# recovery: rediscovery, elastic barriers, restore and rollback (the JAX
# package's tests/test_kvstore_server.py cases), the chaos rpc hooks
# (tests/test_kvstore_async.py's cases)
# ---------------------------------------------------------------------------
@bounded
def test_retry_rediscovers_respawned_server(monkeypatch):
    """A server dies mid-job; its replacement (holding the dead one's
    state) registers with the port's tracker under the old rank on a new
    port, and the client's retry rediscovers it and lands the push."""
    from mxnet_tpu_torch.tracker import Tracker, TrackerClient

    monkeypatch.setenv("MXNET_KVSTORE_RECONNECT_DEADLINE", "0.5")
    trk = Tracker(num_workers=1, num_servers=1, max_restarts=1)
    trk.serve_in_background()
    srv_a = _server(num_workers=1)
    sc_a = TrackerClient(trk.addr, "server", addr=srv_a.addr, rank=0)
    wc = TrackerClient(trk.addr, "worker", rank=0)
    try:
        kv = tks.ServerKVStore([srv_a.addr], tracker_client=wc)
        assert kv.rank == wc.rank == 0
        kv.init("w", np.full((2,), 10.0, np.float32))
        kv.push("w", np.ones((2,), np.float32))
        kv.wait_outstanding()
        srv_a.shutdown()                      # the crash
        sc_a.close()
        srv_b = _server(num_workers=1)
        srv_b._store = {k: v.clone() for k, v in srv_a._store.items()}
        sc_b = TrackerClient(trk.addr, "server", addr=srv_b.addr, rank=0,
                             restart_count=1)
        kv.push("w", np.ones((2,), np.float32))   # reconnect + rediscover
        out = np.empty((2,), np.float32)
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out, 12.0)
        assert kv._uris == [srv_b.addr], "the client never learned the URI"
        kv.close()
        sc_b.close()
        wc.close()
        srv_b.shutdown()
    finally:
        srv_a.shutdown()
        trk.shutdown()


@bounded
def test_elastic_barrier_retracts_dead_waiters_arrival():
    """Elastic mode: a worker dying inside the barrier retracts its own
    arrival; the survivor waits for the respawn, which completes the
    round."""
    def _eat(fn):
        try:
            fn()
        except Exception:
            pass

    srv = _server(num_workers=2, barrier_timeout=20.0, elastic=True)
    try:
        ghost = tks.ServerKVStore(srv.addr)
        t_ghost = threading.Thread(target=lambda: _eat(ghost.barrier))
        t_ghost.start()
        time.sleep(0.3)                  # one pending arrival...
        ghost._socks[0].shutdown(socket.SHUT_RDWR)
        ghost._socks[0].close()          # ...and its worker dies
        t_ghost.join(timeout=10)
        time.sleep(0.6)                  # the probe retracts the arrival
        survivor = tks.ServerKVStore(srv.addr)
        done = []
        t_surv = threading.Thread(
            target=lambda: (survivor.barrier(), done.append("survivor")))
        t_surv.start()
        time.sleep(0.5)
        assert t_surv.is_alive() and done == [], \
            "the survivor passed on the dead worker's stale arrival"
        respawn = tks.ServerKVStore(srv.addr)
        respawn.barrier()
        t_surv.join(timeout=10)
        assert done == ["survivor"]
        survivor.close()
        respawn.close()
    finally:
        _stop(srv)


def _shard_checkpoint(ck_mod, directory):
    """tests/test_kvstore_server.py's checkpoint: eight keys, an aux
    entry, momentum states, an sgd config."""
    keys = ["fc%d_weight" % i for i in range(8)]
    weights = {"arg:%s" % k: np.full((3,), float(i), np.float32)
               for i, k in enumerate(keys)}
    weights["aux:bn_mean"] = np.ones((2,), np.float32)
    weights["arg:emb@embshard1"] = np.arange(6, dtype=np.float32)
    states = {k: np.full((3,), 0.5, np.float32) for k in keys}
    states["emb@embshard1"] = np.full((6,), 0.25, np.float32)
    mgr = ck_mod.CheckpointManager(directory)
    mgr.save(2, weights=weights,
             optimizer_states=pickle.dumps(states, protocol=4),
             optimizer_config=("sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9}, {}))
    return keys + ["emb@embshard1"], mgr


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_server_restore_from_checkpoint_loads_only_its_shard(tmp_path,
                                                             writer):
    """A respawned server preloads exactly its key shard (crc32 routing;
    an embedding sub-key by its suffix) and those keys' optimizer state,
    with the updater rebuilt from the recorded config, from a checkpoint
    either package wrote, as the JAX server restores it."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as tck

    keys, mgr = _shard_checkpoint(tck if writer == "port" else jck,
                                  str(tmp_path / "ck"))
    for shard in range(2):
        got, want = (_server(pkg, num_workers=1) for pkg in ("port", "jax"))
        try:
            n = got.restore_from_checkpoint(mgr.latest(), shard_rank=shard,
                                            num_shards=2)
            jn = want.restore_from_checkpoint(mgr.latest(),
                                              shard_rank=shard, num_shards=2)
            expect = {k for k in keys if (
                1 % 2 if "@embshard" in k else tks.shard_key(k, 2)) == shard}
            assert set(got._store) == set(want._store) == expect
            assert n == jn == len(expect)
            assert got._updater is not None, "optimizer not rebuilt"
            assert set(got._updater.states) == expect
            for k in expect:
                np.testing.assert_array_equal(got._store[k].numpy(),
                                              want._store[k])
                np.testing.assert_array_equal(
                    got._updater.states[k].asnumpy(),
                    want._updater.states[k])
                assert got._store[k].device == got.device
            assert got._opt_config == want._opt_config
        finally:
            _stop(got, want)


@bounded
def test_jax_client_rolls_back_a_port_server(tmp_path, monkeypatch):
    """The wire across packages for recovery: a port server restored from
    a JAX-written checkpoint (its momentum included) takes pushes from the
    JAX client, is poisoned, and the JAX client's ``rollback_servers``
    brings it back to the checkpoint with the lr backed off once a
    generation; the next push moves it as the all-JAX pair does."""
    from mxnet_tpu import checkpoint as jck

    d = str(tmp_path / "ck")
    monkeypatch.setenv("MXNET_CHECKPOINT_DIR", d)
    keys, mgr = _shard_checkpoint(jck, d)
    results = {}
    for pkg in ("port", "jax"):
        srv = _server(pkg, num_workers=1)
        assert srv.restore_from_checkpoint(mgr.latest()) == len(keys)
        kv = jks.ServerKVStore(srv.addr)
        try:
            kv.push("fc3_weight", np.full((3,), np.nan, np.float32))
            bad = np.empty((3,), np.float32)
            kv.pull("fc3_weight", out=bad)
            assert np.isnan(bad).all()
            info = kv.rollback_servers(lr_scale=0.5, gen=1)
            again = kv.rollback_servers(lr_scale=0.5, gen=1)
            restored = np.empty((3,), np.float32)
            kv.pull("fc3_weight", out=restored)
            kv.push("fc3_weight", np.ones((3,), np.float32))
            after = np.empty((3,), np.float32)
            kv.pull("fc3_weight", out=after)
            results[pkg] = (info, again, restored, after,
                            kv.get_optimizer_config())
        finally:
            kv.close()
            _stop(srv)
    got, want = results["port"], results["jax"]
    assert got[0] == want[0] == {"keys": len(keys), "epoch": 2, "lr": 0.05}
    assert got[1] == want[1] and got[1]["lr"] is None
    np.testing.assert_array_equal(got[2], np.full((3,), 3.0, np.float32))
    # the momentum buffer 0.5 restored: w + 0.9 * 0.5 - lr 0.05 * 1
    _close(got[3], want[3])
    _close(got[3], np.full((3,), 3.0 + 0.9 * 0.5 - 0.05))
    assert got[4] == want[4]


@pytest.fixture
def chaos_env(monkeypatch):
    from mxnet_tpu_torch import chaos

    def _set(spec):
        monkeypatch.setenv("MXNET_FAULT_SPEC", spec)
        monkeypatch.setenv("DMLC_ROLE", "worker")
        chaos.reset_engine()

    yield _set
    monkeypatch.delenv("MXNET_FAULT_SPEC", raising=False)
    chaos.reset_engine()


@bounded
def test_future_ordering_under_chaos_drops(server1, chaos_env):
    """Seeded send-phase drops on the port's client against the port's
    server: every push lands exactly once (accumulate mode: a double or a
    lost apply changes the sum), in the no-fault run's final state."""
    chaos_env("rpc:drop@op=push,p=0.3,seed=11")
    kv = tks.ServerKVStore(server1.addr)
    keys = ["k%02d" % i for i in range(12)]
    for k in keys:
        kv.init(k, np.zeros((8,), np.float32))
    rng = np.random.RandomState(0)
    expect = {k: np.zeros((8,), np.float32) for k in keys}
    for _step in range(4):
        for i, k in enumerate(keys):
            g = rng.rand(8).astype(np.float32)
            expect[k] += g
            kv.push(k, g, priority=-i)
    kv.wait_outstanding()
    assert server1._pushes_applied == len(keys) * 4
    assert profiler.comm_stats()["push"]["count"] > 0
    for k in keys:
        out = np.empty((8,), np.float32)
        kv.pull(k, out=out)
        np.testing.assert_allclose(out, expect[k], rtol=1e-6)
    kv.close()


@bounded
@pytest.mark.parametrize("side", ["client", "server"])
def test_reply_loss_on_coalesced_frame_never_double_applies(server1,
                                                            chaos_env, side):
    """A ``push_multi`` frame whose reply is lost (client side) retries
    with the same per-entry seqnos and is acked without a second apply; a
    server-side drop before the apply is retried and applied once."""
    chaos_env("rpc:drop@op=push,phase=reply,n=1" if side == "client"
              else "rpc:drop@op=push,side=server,n=1")
    kv = tks.ServerKVStore(server1.addr)
    keys = ["a", "b", "c", "d"]
    for k in keys:
        kv.init(k, np.zeros((4,), np.float32))
    for k in keys:
        kv.push(k, np.ones((4,), np.float32))
    kv.wait_outstanding()
    assert server1._pushes_applied == len(keys), "a retry re-applied"
    for k in keys:
        out = np.empty((4,), np.float32)
        kv.pull(k, out=out)
        np.testing.assert_array_equal(out, 1.0)
    kv.close()


def test_server_chaos_crash_at_its_step(server1, monkeypatch):
    """``server:0:crash@step=3``: the server's third applied push hard-exits
    (the exit injected here), as the JAX server counts its steps."""
    from mxnet_tpu import chaos as jchaos
    from mxnet_tpu_torch import chaos

    exits = {}
    for name, mod in (("port", chaos), ("jax", jchaos)):
        monkeypatch.setenv("MXNET_FAULT_SPEC", "server:0:crash@step=3")
        monkeypatch.setenv("DMLC_ROLE", "server")
        mod.reset_engine()
        eng = mod.engine()
        eng._exit = lambda code, name=name: exits.setdefault(name, (
            code, eng._step))
        if name == "port":
            kv = tks.ServerKVStore(server1.addr, pipeline=False)
            kv.init("w", np.zeros((2,), np.float32))
            for _ in range(4):
                kv.push("w", np.ones((2,), np.float32))
            kv.close()
        else:
            for _ in range(4):
                mod.tick_step()
        mod.reset_engine()
    assert exits["port"] == exits["jax"] == (137, 3)


@bounded
def test_elastic_checkpoint_pulls_inside_the_quiesced_window(tmp_path,
                                                             monkeypatch):
    """``callback.elastic_checkpoint`` on the server tier, one worker and
    one server a package, every second epoch of a 4-epoch ``Module.fit``:
    the named barriers pass, the weights committed are the servers'
    (pulled in the window), with the servers' optimizer states and config
    and the worker's progress; the port's checkpoint equals the JAX
    package's."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as tck

    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    x, y, params = _mlp_case(200)
    got = {}
    for pkg, mx, ks, ck_mod in (("port", tmx, tks, tck),
                                ("jax", jmx, jks, jck)):
        srv = _server(pkg, num_workers=1)
        kv = ks.ServerKVStore(srv.addr)
        mgr = ck_mod.CheckpointManager(str(tmp_path / pkg), period=2)
        x2, y2 = x[:100], y[:100]           # 2 batches an epoch
        it = mx.io.NDArrayIter({"data": x2}, {"softmax_label": y2},
                               batch_size=50, shuffle=False)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                    num_hidden=32)
        net = mx.sym.Activation(net, name="relu1", act_type="relu")
        net = mx.sym.FullyConnected(net, name="fc2", num_hidden=5)
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in params.items()},
                kvstore=kv, num_epoch=4,
                epoch_end_callback=mx.callback.elastic_checkpoint(mgr, mod,
                                                                  kv))
        ck = mgr.latest()
        held = {}
        for k in params:
            held[k] = np.empty_like(params[k])
            kv.pull(k, out=held[k])
        got[pkg] = dict(
            epochs=sorted(n for n in os.listdir(str(tmp_path / pkg))
                          if n.startswith("ckpt-")),
            files=sorted(os.listdir(ck.path)), weights=ck.weights(),
            config=ck.optimizer_config(),
            states=tck.loads_plain(ck.optimizer_states()),
            worker=ck.worker_state(0), held=held)
        _stop(kv, srv)
    t, j = got["port"], got["jax"]
    assert t["epochs"] == j["epochs"] == ["ckpt-00000002", "ckpt-00000004"]
    assert t["files"] == j["files"] == ["meta.json", "optimizer.pkl",
                                        "optimizer.states", "weights.pkl",
                                        "worker-0.pkl"]
    assert t["config"] == j["config"]
    assert (t["worker"]["epoch"], t["worker"]["nbatch"]) == \
        (j["worker"]["epoch"], j["worker"]["nbatch"]) == (4, 0)
    assert set(t["weights"]) == {"arg:%s" % k for k in params}
    for k in params:
        np.testing.assert_array_equal(t["weights"]["arg:" + k], t["held"][k])
        _close(t["weights"]["arg:" + k], j["weights"]["arg:" + k], k)
    assert set(t["states"]) == set(j["states"]) == set(params)
    for k in params:
        _close(t["states"][k], j["states"][k], "momentum " + k)


# ---------------------------------------------------------------------------
# ZeRO value sharding over the servers (tests/test_kvstore_server.py's
# test_zero_server_* cases), the entry point and the retries
# ---------------------------------------------------------------------------
@pytest.fixture
def zero_server_env(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_ZERO_SERVER", "1")
    monkeypatch.setenv("MXNET_TPU_ZERO_MIN_SIZE", "8")


def _local_sgd_mom(w0, grads, lr=0.1, momentum=0.9):
    """The JAX package's local updater over the gradients."""
    opt = jmx.optimizer.create("sgd", learning_rate=lr, momentum=momentum)
    upd = jmx.optimizer.get_updater(opt)
    w = jmx.nd.array(w0)
    for g in grads:
        upd("w", jmx.nd.array(g), w)
    return w.asnumpy()


def _zero_train(ks, addrs, w0, grads):
    kv = ks.ServerKVStore(addrs)
    kv.init("w", w0)
    kv.init("tiny", np.zeros((3,), np.float32))  # 3 < the min size
    kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
    for g in grads:
        kv.push("w", g)
    out = np.empty_like(w0)
    kv.pull("w", out=out)
    kv.close()
    return out


@bounded
def test_zero_server_value_shards_and_matches_local(zero_server_env):
    """A large dense key's value and optimizer state are split over both
    servers (half each), push and pull keep the server-side optimizer's
    contract (the JAX local updater's weights), a small key stays whole
    on its crc32 server."""
    srv = [_server(num_workers=1) for _ in range(2)]
    try:
        rng = np.random.RandomState(0)
        w0 = rng.randn(4, 5).astype(np.float32)
        grads = [rng.randn(4, 5).astype(np.float32) for _ in range(4)]
        out = _zero_train(tks, [s.addr for s in srv], w0, grads)
        _close(out, _local_sgd_mom(w0, grads), "w")
        for s in srv:
            assert s._store["w"].numel() == 10
            assert s._updater.states["w"].size == 10
        assert ("tiny" in srv[0]._store) != ("tiny" in srv[1]._store)
    finally:
        _stop(*srv)


@bounded
def test_zero_server_jax_client_on_port_servers_matches_port_client(
        zero_server_env):
    """The cross case: the JAX client under ZeRO splits a key over two
    port servers exactly as the port's client does, and both pull the
    same weights."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(6, 7).astype(np.float32)
    grads = [rng.randn(6, 7).astype(np.float32) for _ in range(3)]
    got = {}
    for name, ks in (("jax", jks), ("port", tks)):
        srv = [_server(num_workers=1) for _ in range(2)]
        try:
            got[name] = _zero_train(ks, [s.addr for s in srv], w0, grads)
            assert [s._store["w"].numel() for s in srv] == [21, 21]
        finally:
            _stop(*srv)
    np.testing.assert_array_equal(got["jax"], got["port"])
    _close(got["port"], _local_sgd_mom(w0, grads), "w")


@bounded
def test_zero_server_states_merge_full_and_resplit_on_new_topology(
        zero_server_env, tmp_path):
    """save_optimizer_states joins the servers' state slices whole (a file
    independent of the server count); loading it under three servers
    splits it three ways and training continues as the local updater."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(6, 3).astype(np.float32)
    grads = [rng.randn(6, 3).astype(np.float32) for _ in range(3)]
    fname = str(tmp_path / "zero.states")
    two = [_server(num_workers=1) for _ in range(2)]
    try:
        kv = tks.ServerKVStore([s.addr for s in two])
        kv.init("w", w0)
        kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
        for g in grads[:2]:
            kv.push("w", g)
        mid = np.empty_like(w0)
        kv.pull("w", out=mid)
        kv.save_optimizer_states(fname)
        kv.close()
    finally:
        _stop(*two)
    saved = pickle.loads(open(fname, "rb").read())
    assert np.asarray(saved["w"]).shape == (6, 3)
    three = [_server(num_workers=1) for _ in range(3)]
    try:
        kv = tks.ServerKVStore([s.addr for s in three])
        kv.init("w", mid)
        kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
        kv.load_optimizer_states(fname)
        for s in three:
            assert s._updater.states["w"].size == 6
        kv.push("w", grads[2])
        out = np.empty_like(w0)
        kv.pull("w", out=out)
        _close(out, _local_sgd_mom(w0, grads), "w")
        kv.close()
    finally:
        _stop(*three)


@bounded
def test_zero_server_restore_from_checkpoint_slices(zero_server_env,
                                                    tmp_path):
    """A respawned server restores exactly its flat slice of a split key's
    weights and optimizer state, as the JAX package's server does."""
    from mxnet_tpu.checkpoint import CheckpointManager

    w = np.arange(20, dtype=np.float32).reshape(4, 5)
    mom = -np.arange(20, dtype=np.float32).reshape(4, 5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(epoch=1, weights={"arg:w": w, "arg:tiny": np.ones((3,))},
             optimizer_states=pickle.dumps({"w": mom}),
             optimizer_config=("sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9}, {}))
    srv = tks.KVStoreServer(device="cpu")
    jsrv = jks.KVStoreServer()
    try:
        n = srv.restore_from_checkpoint(mgr.latest(), shard_rank=1,
                                        num_shards=2)
        jn = jsrv.restore_from_checkpoint(mgr.latest(), shard_rank=1,
                                          num_shards=2)
        assert n == jn >= 1
        np.testing.assert_array_equal(srv._store["w"].numpy(),
                                      w.reshape(-1)[10:])
        np.testing.assert_array_equal(srv._updater.states["w"].asnumpy(),
                                      mom.reshape(-1)[10:])
        assert sorted(srv._store) == sorted(jsrv._store)
    finally:
        srv.shutdown()
        jsrv.shutdown()


@bounded
def test_zero_server_knob_validation(server, monkeypatch):
    """A malformed MXNET_TPU_ZERO_SERVER raises at the client's
    construction, even for one server."""
    monkeypatch.setenv("MXNET_TPU_ZERO_SERVER", "banana")
    with pytest.raises(MXNetError, match="MXNET_TPU_ZERO_SERVER"):
        tks.ServerKVStore(server.addr)


def _entry_env(**kw):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("DMLC_", "MXNET_PS_", "MXNET_CHECKPOINT")):
            del env[k]
    env.update(DMLC_ROLE="server", MXNET_KVSTORE_SERVER="1",
               MXNET_PS_BIND_PORT="0", MXNET_PS_SERVER_DEVICE="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    env.update(kw)
    return env


def _entry_point(env):
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"],
        env=env, stdout=subprocess.PIPE, text=True)


@bounded
def test_entrypoint_serves_when_opted_in(tmp_path):
    """``python -m mxnet_tpu_torch.kvstore_server`` under DMLC_ROLE=server
    and MXNET_KVSTORE_SERVER=1 serves (bound as MXNET_PS_BIND_* say); a
    client of either package trains a key through it, then stops it."""
    proc = _entry_point(_entry_env(MXNET_PS_BIND_HOST="127.0.0.1"))
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line, line
        addr = line.strip().rsplit(" ", 1)[-1]
        kv = jks.ServerKVStore(addr)
        kv.init("w", np.full((2,), 5.0, np.float32))
        kv.set_optimizer("sgd", learning_rate=1.0)
        kv.push("w", np.ones((2,), np.float32))
        out = np.empty((2,), np.float32)
        kv.pull("w", out=out)
        np.testing.assert_allclose(out, 4.0)  # 5 - 1.0 * grad
        kv.stop_server()
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.stdout.close()


@bounded
def test_entrypoint_restores_checkpoint_on_fresh_start(tmp_path):
    """A server started against a checkpoint directory restores from it
    before it serves, restart count or not, and says so on its lifecycle
    line."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    w = np.arange(6, dtype=np.float32)
    CheckpointManager(str(tmp_path / "ck")).save(
        4, weights={"arg:w": w},
        optimizer_states=pickle.dumps({"w": np.ones((6,), np.float32)}),
        optimizer_config=("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                          {}))
    proc = _entry_point(_entry_env(MXNET_CHECKPOINT_DIR=str(tmp_path
                                                            / "ck")))
    try:
        line = proc.stdout.readline()
        assert "[lifecycle] event=restored-from role=server rank=0" in line \
            and "keys=1 epoch=4" in line, line
        line = proc.stdout.readline()
        assert "listening on" in line, line
        kv = tks.ServerKVStore(line.strip().rsplit(" ", 1)[-1])
        out = np.empty((6,), np.float32)
        kv.pull("w", out=out)  # no init: the store is restored
        np.testing.assert_array_equal(out, w)
        kv.stop_server()
        assert proc.wait(timeout=30) == 0
        kv.close()
    finally:
        proc.kill()
        proc.stdout.close()


@pytest.mark.parametrize("role,opt_in", [("worker", "1"), ("server", "0"),
                                         ("scheduler", "0")])
def test_entrypoint_exits_zero_without_its_role(role, opt_in, monkeypatch):
    """A worker role returns, a server without MXNET_KVSTORE_SERVER=1 and a
    scheduler without the tracker's environment exit 0, serving
    nothing."""
    for k, v in _entry_env(DMLC_ROLE=role,
                           MXNET_KVSTORE_SERVER=opt_in).items():
        if k.startswith(("DMLC_", "MXNET_KVSTORE_SERVER")):
            monkeypatch.setenv(k, v)
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    if role == "worker":
        assert tks._init_kvstore_server_module() is None
        return
    with pytest.raises(SystemExit) as e:
        tks._init_kvstore_server_module()
    assert e.value.code == 0


@bounded
def test_push_retry_after_reply_loss_is_idempotent(server, chaos_env):
    """The push is applied, its reply lost, the retry carries the same
    seqno: acked, not applied twice."""
    chaos_env("rpc:drop@op=push,phase=reply,n=1")
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((3,), np.float32))
    kv.push("w", np.ones((3,), np.float32))
    out = np.empty((3,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 1.0)
    assert server._pushes_applied == 1
    kv.close()


@bounded
def test_push_retry_after_send_drop_applies_once(server, chaos_env):
    chaos_env("rpc:drop@op=push,n=1")
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.zeros((2,), np.float32))
    kv.push("w", np.full((2,), 5.0, np.float32))
    out = np.empty((2,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 5.0)
    kv.close()


@bounded
def test_pull_retries_transparently(server, chaos_env):
    chaos_env("rpc:drop@op=pull,n=1")
    kv = tks.ServerKVStore(server.addr)
    kv.init("w", np.full((2,), 3.0, np.float32))
    out = np.empty((2,), np.float32)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out, 3.0)
    kv.close()


@bounded
def test_error_replies_are_never_retried(server, chaos_env):
    """A rejection is not a transport failure: it lands on the push's
    future once, and the data plane stays failed."""
    chaos_env("rpc:drop@op=pull,n=0")
    kv = tks.ServerKVStore(server.addr)
    before = server._pushes_applied
    kv.push("never_inited", np.ones((2,), np.float32))
    with pytest.raises(MXNetError, match="push before init"):
        kv.wait_outstanding()
    assert server._pushes_applied == before
    with pytest.raises(MXNetError, match="asynchronous push failed"):
        kv.push("w", np.ones((2,), np.float32))
    kv.close()


@bounded
def test_dead_shard_error_names_the_shard(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RPC_RETRIES", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RECONNECT_DEADLINE", "0.3")
    srv = _server(num_workers=1)
    kv = tks.ServerKVStore(srv.addr)
    kv.init("w", np.zeros((2,), np.float32))
    srv.shutdown()
    with pytest.raises(MXNetError, match=r"push.*shard 0 \(%s\).*failed "
                       r"after 2" % srv.addr):
        kv.push("w", np.ones((2,), np.float32))
        kv.wait_outstanding()
    kv.close()
