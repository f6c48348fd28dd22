"""The port's input pipeline on the CPU: ``parallel.DeviceQueueIter`` (the
background feed that places each batch for the mesh), ``io.PrefetchingIter``
(scenarios of tests/test_input_pipeline.py), and a tiny
``Module.fit(kvstore='tpu')`` fed by ``ShardedBatchIter`` ->
``DeviceQueueIter`` over record shards, held bit for bit against the same
fit fed by ``NDArrayIter`` over the same rows, and against the JAX
package's ``Module.fit`` within rtol 1e-4 / atol 1e-5. The mesh is a
one-rank gloo mesh on the CPU (``make_mesh({"dp": 1}, device="cpu")``)."""
import struct
import threading
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel.feed import (DeviceQueueIter, expected_sharding,
                                           is_preplaced)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"dp": 1}, device="cpu")


def _data(n=256, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = x.dot(rng.randn(d, classes)).argmax(axis=1).astype(np.float32)
    return x, y


class _CountingIter(mx.io.DataIter):
    """Wraps a DataIter, counting next() calls and supporting close()."""

    def __init__(self, inner, delay=0.0):
        super().__init__(inner.batch_size)
        self.inner = inner
        self.pulled = 0
        self.closed = False
        self.delay = delay

    @property
    def provide_data(self):
        return self.inner.provide_data

    @property
    def provide_label(self):
        return self.inner.provide_label

    def reset(self):
        self.inner.reset()

    def next(self):
        if self.delay:
            time.sleep(self.delay)
        self.pulled += 1
        return self.inner.next()

    def close(self):
        self.closed = True


# ---------------------------------------------------------------------------
# DeviceQueueIter
# ---------------------------------------------------------------------------
def test_device_queue_matches_sync_path_bitexact(mesh):
    x, y = _data(n=128)
    sharding = expected_sharding(mesh, ("dp",))
    sync_it = mx.io.NDArrayIter(x, y, batch_size=32)
    profiler.pipeline_reset()
    with DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32),
                         mesh=mesh) as dq:
        n = 0
        for sync_b, dev_b in zip(sync_it, dq):
            for host, placed in zip(sync_b.data + sync_b.label,
                                    dev_b.data + dev_b.label):
                assert is_preplaced(placed.tensor, sharding)
                assert placed.tensor.device.type == "cpu"
                np.testing.assert_array_equal(host.asnumpy(),
                                              placed.asnumpy())
            n += 1
    assert n == 4
    stats = profiler.pipeline_stats(reset=True)
    assert stats["puts"] == 8 and stats["batches"] == 4
    assert "avg_put_ms" in stats and "avg_stall_feed_ms" in stats


def test_device_queue_ordering_and_epoch_parity(mesh):
    x, y = _data(n=192)
    with DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32),
                         mesh=mesh) as dq:
        seen = np.concatenate([b.label[0].asnumpy() for b in dq])
        np.testing.assert_array_equal(seen, y)
        with pytest.raises(StopIteration):
            dq.next()
        dq.reset()
        seen2 = np.concatenate([b.label[0].asnumpy() for b in dq])
        np.testing.assert_array_equal(seen2, y)


def test_device_queue_bounded_depth(mesh):
    x, y = _data(n=512)
    src = _CountingIter(mx.io.NDArrayIter(x, y, batch_size=32))
    with DeviceQueueIter(src, mesh=mesh, depth=2) as dq:
        dq.next()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and src.pulled < 4:
            time.sleep(0.02)
        time.sleep(0.1)
        # consumed 1 + queue depth 2 + 1 being placed on the worker
        assert src.pulled <= 4, src.pulled


def test_device_queue_reset_mid_epoch_and_close(mesh):
    x, y = _data(n=256)
    src = _CountingIter(mx.io.NDArrayIter(x, y, batch_size=32))
    dq = DeviceQueueIter(src, mesh=mesh)
    dq.next()
    dq.reset()
    assert sum(1 for _ in dq) == 8
    dq.close()
    assert dq._thread is None and src.closed
    dq.close()
    with pytest.raises(MXNetError):
        dq.next()
    with pytest.raises(MXNetError):
        dq.reset()
    assert not any(t.name == "DeviceQueueIter" and t.is_alive()
                   for t in threading.enumerate())


def test_device_queue_depth_validation(mesh, monkeypatch):
    x, y = _data(n=64)
    with pytest.raises(MXNetError, match="depth must be >= 1"):
        DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32), mesh=mesh,
                        depth=0)
    with pytest.raises(MXNetError, match="need a mesh"):
        DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32))
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "0")
    with pytest.raises(MXNetError, match="MXNET_TPU_FEED_DEPTH"):
        DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32), mesh=mesh)
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "3")
    with DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32),
                         mesh=mesh) as dq:
        assert dq.depth == 3


def test_device_queue_worker_error_surfaces(mesh):
    class _Boom(mx.io.DataIter):
        provide_data = [("data", (8, 4))]
        provide_label = [("softmax_label", (8,))]

        def next(self):
            raise ValueError("decoder exploded")

    with DeviceQueueIter(_Boom(), mesh=mesh) as dq:
        with pytest.raises(ValueError, match="decoder exploded"):
            dq.next()
        with pytest.raises(ValueError):
            dq.next()  # sticky


def test_device_queue_distributed_placement_raises(mesh):
    """``distributed=True``, refused before, places each worker's own rows
    whole (here one worker); a local batch that changes mid-stream raises
    on the consumer, not swallowed (two workers: tests/test_torch_dist.py)."""
    x, y = _data(n=64)
    with DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32), mesh=mesh,
                         distributed=True) as dq:
        first = dq.next().data[0].asnumpy()
        np.testing.assert_array_equal(first, x[:32])

    class _Shrinking(mx.io.NDArrayIter):
        """Batches of 32 rows, then one of 16."""

        def next(self):
            batch = super().next()
            if self.cursor > 0:
                batch.data = [d[:16] for d in batch.data]
                batch.label = [lb[:16] for lb in batch.label]
            return batch

    with DeviceQueueIter(_Shrinking(x, y, batch_size=32), mesh=mesh,
                         distributed=True) as dq:
        dq.next()
        with pytest.raises(MXNetError, match="changed mid-stream"):
            dq.next()


def _mlp(mxp):
    data = mxp.sym.Variable("data")
    net = mxp.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mxp.sym.Activation(net, act_type="relu")
    net = mxp.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mxp.sym.SoftmaxOutput(net, name="softmax")


def test_device_queue_passthrough_without_fused_group():
    x, y = _data(n=128)
    it = mx.io.NDArrayIter(x, y, batch_size=32)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(kvstore="local", optimizer="sgd")
    with DeviceQueueIter(mx.io.NDArrayIter(x, y, batch_size=32),
                         module=mod) as dq:
        with pytest.warns(UserWarning, match="no fused SPMD group"):
            batch = dq.next()
        assert batch.data[0].asnumpy().shape == (32, 16)


# ---------------------------------------------------------------------------
# PrefetchingIter
# ---------------------------------------------------------------------------
def test_prefetching_iter_close_joins_threads():
    x, y = _data(n=96)
    pf = mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=32))
    threads = list(pf.prefetch_threads)
    next(iter(pf))
    pf.close()
    assert all(not t.is_alive() for t in threads)
    pf.close()
    with pytest.raises(MXNetError):
        pf.reset()
    with pytest.raises(MXNetError):
        pf.iter_next()


def test_prefetching_iter_close_mid_fetch_joins_promptly():
    x, y = _data(n=96)
    fetching = threading.Event()

    class _SignallingIter(_CountingIter):
        def next(self):
            if self.pulled >= 1:
                fetching.set()
                time.sleep(0.4)
            return super().next()

    pf = mx.io.PrefetchingIter(
        _SignallingIter(mx.io.NDArrayIter(x, y, batch_size=32)))
    threads = list(pf.prefetch_threads)
    next(iter(pf))
    assert fetching.wait(timeout=5)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 3.0
    assert all(not t.is_alive() for t in threads)


def test_prefetching_iter_context_manager_and_source_close():
    x, y = _data(n=96)
    src = _CountingIter(mx.io.NDArrayIter(x, y, batch_size=32))
    with mx.io.PrefetchingIter(src) as pf:
        threads = list(pf.prefetch_threads)
        next(iter(pf))
    assert all(not t.is_alive() for t in threads) and src.closed


def test_prefetching_iter_reset_after_stopiteration_matches_jax():
    x, y = _data(n=96)
    got = {}
    for name, pkg in (("torch", mx), ("jax", jmx)):
        with pkg.io.PrefetchingIter(
                pkg.io.NDArrayIter(x, y, batch_size=32)) as pf:
            first = [b.label[0].asnumpy().copy() for b in pf]
            pf.reset()
            second = [b.label[0].asnumpy().copy() for b in pf]
        assert len(first) == len(second) == 3
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        got[name] = np.concatenate(first)
    np.testing.assert_array_equal(got["torch"], got["jax"])


def test_prefetching_iter_raises_a_source_error():
    class _Boom(mx.io.DataIter):
        provide_data = [mx.io.DataDesc("data", (8, 4))]
        provide_label = [mx.io.DataDesc("softmax_label", (8,))]

        def next(self):
            raise ValueError("source exploded")

    with mx.io.PrefetchingIter(_Boom()) as pf:
        with pytest.raises(ValueError, match="source exploded"):
            pf.next()


# ---------------------------------------------------------------------------
# Module.fit through the data plane
# ---------------------------------------------------------------------------
FIT_N, FIT_D, FIT_BATCH, FIT_EPOCHS = 64, 16, 16, 2


def decode_row(raw, seed):
    """``<f label><FIT_D float32>`` -> (row, label), no augmentation."""
    (label,) = struct.unpack_from("<f", raw, 0)
    return (np.frombuffer(raw, np.float32, FIT_D, 4).copy(),
            np.float32(label))


def _fit_init(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(32, FIT_D).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(32, np.float32),
            "fc2_weight": rng.randn(4, 32).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(4, np.float32)}


def _fit(mxp, make_iter, context, epoch_end_callback=None):
    mod = mxp.mod.Module(_mlp(mxp), context=context)
    train = make_iter(mod)
    mod.fit(train, eval_metric="acc", kvstore="tpu", num_epoch=FIT_EPOCHS,
            arg_params={k: mxp.nd.array(v) for k, v in _fit_init().items()},
            optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                               "momentum": 0.9},
            epoch_end_callback=epoch_end_callback)
    fused = getattr(mod, "_fused", None) is not None
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return params, fused, train


def test_module_fit_through_the_data_plane(tmp_path):
    x, y = _data(n=FIT_N, d=FIT_D)
    recs = [struct.pack("<f", float(y[i])) + x[i].tobytes()
            for i in range(FIT_N)]
    mpath = tdata.write_record_shards(str(tmp_path), "fit", recs,
                                      num_shards=4)

    def sharded(mod):
        stream = tdata.ShardedRecordStream(
            mpath, lease_client=tdata.LocalLeaseAuthority(ttl=600), rank=0,
            decode=decode_row, workers=0, prefetch=2, chunk=FIT_BATCH)
        return DeviceQueueIter(tdata.ShardedBatchIter(stream, FIT_BATCH,
                                                      (FIT_D,)),
                               module=mod)

    profiler.io_reset()
    io = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no pass-through warning
        fed, fused, dq = _fit(mx, sharded, mx.cpu(),
                              lambda *_: io.append(profiler.io_stats()))
    dq.close()
    profiler.io_reset()
    assert fused and dq.mesh is not None
    # every record read once an epoch, counted at each epoch's end (before
    # fit's reset lets the feed read ahead into an epoch nobody trains)
    assert [st["records"] for st in io] == [FIT_N * (e + 1)
                                            for e in range(FIT_EPOCHS)]
    assert io[-1]["batches"] == FIT_EPOCHS * FIT_N // FIT_BATCH
    plain, fused_plain, _ = _fit(
        mx, lambda mod: mx.io.NDArrayIter(x, y, batch_size=FIT_BATCH),
        mx.cpu())
    assert fused_plain
    for k in plain:
        np.testing.assert_array_equal(fed[k], plain[k], err_msg=k)
    want, jfused, _ = _fit(
        jmx, lambda mod: jmx.io.NDArrayIter(x, y, batch_size=FIT_BATCH),
        [jmx.cpu(0)])
    assert jfused
    for k in want:
        np.testing.assert_allclose(fed[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
