"""The port's sharded embedding table (``mxnet_tpu_torch/embedding``)
against the JAX package, on the CPU: two in-process servers a package,
built with ``device="cpu"``.

The scenarios of ``tests/test_embedding.py``'s sharding and table
sections: the row sharding's bijection, balance and hot-head striping
(the same (shard, local) pairs as the JAX package's ``RowSharding``),
sub-key naming, validation, knob validation and the shard-count knob,
init/pull parity with dedup, the dedup accounting and ``embeddingStats``
in ``dump_profile``, push parity with duplicates combined on the client,
server-side momentum at 1/n of the bytes a server, the out-of-vocabulary
raise before any RPC, the pull-batch budget, the naive per-id mode and
the 2-bit wire's error feedback. Each table result is held against the
JAX package's table on the same seeded inputs. ``SparseEmbedding``'s
three scenarios run in both packages, and the lookup server is held
against the JAX one in tests/test_torch_lookup.py.

``elastic_table_checkpoint`` in both packages: a fresh server restores
exactly its suffix-routed sub-key and that key's momentum
(``tests/test_embedding.py``'s checkpoint case), and the chaos case in
one process: ``server:0:crash@step=N`` stops a server mid-training, its
replacement restores the checkpoint's sub-key and registers with the
tracker under the old rank, the client rediscovers it, and the loss keeps
falling.

Every test body runs under a deadline and servers bind ``127.0.0.1:0``.
Tolerance: fp32, rtol 1e-4 and atol 1e-5; ids, counts and bytes exact.
"""
import json

import numpy as np
import pytest

import mxnet_tpu.embedding as jemb
from mxnet_tpu import kvstore_server as jks
from mxnet_tpu import profiler as jprof
import mxnet_tpu_torch.embedding as temb
from mxnet_tpu_torch import kvstore_server as tks
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.embedding import (EmbeddingShardError, RowSharding,
                                       ShardedEmbeddingTable,
                                       embedding_shard_rank,
                                       embedding_sub_key)

from torch_kvstore_helpers import _close, _stop, _within, bounded

PKGS = {"port": (tks, temb, profiler), "jax": (jks, jemb, jprof)}


class _Cluster:
    """Two servers and a client of one package."""

    def __init__(self, pkg, n=2):
        ks, self.emb, self.prof = PKGS[pkg]
        self.servers = [tks.KVStoreServer(device="cpu") if pkg == "port"
                        else jks.KVStoreServer() for _ in range(n)]
        for s in self.servers:
            s.serve_in_background()
        self.kv = ks.ServerKVStore(",".join(s.addr for s in self.servers))
        self.prof.embedding_reset()

    def table(self, rows=60, dim=8, full=None, **kw):
        t = self.emb.ShardedEmbeddingTable("emb", self.kv, rows, dim, **kw)
        t.init(init_array=full)
        return t

    def close(self):
        _stop(self.kv, *self.servers)
        self.prof.embedding_reset()


@pytest.fixture
def clusters():
    made = {}

    def make(pkg):
        made[pkg] = _Cluster(pkg)
        return made[pkg]

    yield make
    for c in made.values():
        c.close()


def _both(clusters, fn):
    """``fn(cluster)`` on a port cluster and a JAX cluster."""
    return fn(clusters("port")), fn(clusters("jax"))


# ---------------------------------------------------------------------------
# sharding math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,shards", [(1, 1), (2, 2), (101, 4),
                                         (4096, 3), (1 << 20, 4)])
def test_row_sharding_bijection_balance_and_jax_parity(rows, shards):
    rs = RowSharding(rows, shards)
    jrs = jemb.RowSharding(rows, shards)
    assert rs.multiplier == jrs.multiplier and rs.sizes == jrs.sizes
    ids = np.arange(min(rows, 1 << 14), dtype=np.int64)
    s, loc = rs.shard_and_local(ids)
    js, jloc = jrs.shard_and_local(ids)
    assert (s == js).all() and (loc == jloc).all()
    if rows <= 4096:
        assert len(set(zip(s.tolist(), loc.tolist()))) == rows
        assert sorted(rs.sizes) == sorted(
            np.bincount(s, minlength=shards).tolist())
    assert max(rs.sizes) - min(rs.sizes) <= 1
    for sh in range(shards):
        g = rs.global_ids(sh)
        assert (g == jrs.global_ids(sh)).all()
        s2, l2 = rs.shard_and_local(g[:4096])
        assert (s2 == sh).all()
        assert (l2 == np.arange(min(rs.sizes[sh], 4096))).all()
    for (a, sa, la), (b, sb, lb) in zip(rs.group(ids[::3]),
                                        jrs.group(ids[::3])):
        assert a == b and (sa == sb).all() and (la == lb).all()


def test_sharding_stripes_the_hot_head():
    s, _ = RowSharding(100000, 4).shard_and_local(np.arange(64))
    assert np.bincount(s, minlength=4).min() >= 8


def test_sub_key_naming_and_rank_parse():
    assert embedding_sub_key("user_emb", 3) == "user_emb@embshard3"
    assert embedding_shard_rank("user_emb@embshard3") == 3
    assert embedding_shard_rank("user_emb") is None
    assert embedding_shard_rank("fc1_weight") is None


def test_sharding_validation():
    for rows, shards in ((0, 1), (4, 5), (4, 0), (1 << 31, 2)):
        with pytest.raises(MXNetError):
            RowSharding(rows, shards)


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------
@bounded
def test_knob_validation(clusters, monkeypatch):
    kv = clusters("port").kv
    for knob, bad in (("MXNET_EMBED_DEDUP", "maybe"),
                      ("MXNET_EMBED_PULL_BATCH", "zero"),
                      ("MXNET_EMBED_WIRE", "3bit"),
                      ("MXNET_EMBED_WIRE_THRESHOLD", "-1"),
                      ("MXNET_EMBED_SHARDS", "-2")):
        monkeypatch.setenv(knob, bad)
        with pytest.raises(MXNetError, match=knob):
            ShardedEmbeddingTable("k", kv, 10, 4)
        monkeypatch.delenv(knob)
    with pytest.raises(EmbeddingShardError, match="ServerKVStore"):
        ShardedEmbeddingTable("k", object(), 10, 4)


@bounded
def test_shards_knob_override(clusters, monkeypatch):
    kv = clusters("port").kv
    monkeypatch.setenv("MXNET_EMBED_SHARDS", "3")
    t = ShardedEmbeddingTable("k3", kv, 30, 4)
    assert t.num_shards == 3
    assert t.server_of(2) == 0


# ---------------------------------------------------------------------------
# the table's data plane
# ---------------------------------------------------------------------------
@bounded
def test_init_pull_parity(clusters):
    full = np.random.RandomState(0).randn(60, 8).astype(np.float32)
    ids = np.array([3, 7, 3, 59, 0, 7, 31])

    def run(c):
        t = c.table(full=full)
        uniq, inverse, vecs = t.pull(ids)
        seeded = c.emb.ShardedEmbeddingTable("seeded", c.kv, 50, 4)
        seeded.init(seed=3)
        return (uniq, inverse, vecs, t.as_dense(), seeded.as_dense(),
                t.lookup(ids.reshape(7, 1)))

    t, j = _both(clusters, run)
    assert t[0].tolist() == j[0].tolist() and t[0].size == 5
    assert t[1].tolist() == j[1].tolist()
    np.testing.assert_array_equal(t[2][t[1]], full[ids])
    np.testing.assert_array_equal(t[3], full)
    np.testing.assert_array_equal(t[4], j[4])   # per-shard seeded init
    assert t[5].shape == (7, 1, 8)


@bounded
def test_dedup_accounting_and_stats_ride(clusters, tmp_path):
    c = clusters("port")
    t = c.table()
    t.pull(np.array([1, 1, 1, 2]))
    stats = profiler.embedding_stats()
    assert stats["ids_requested"] == 4
    assert stats["unique_ids"] == 2
    assert stats["dedup_ratio"] == 0.5
    assert stats["rows_pulled"] == 2
    assert stats["shard_bytes"]
    assert "pull_p99_ms" in stats
    out = tmp_path / "profile.json"
    profiler.set_config(filename=str(out))
    try:
        profiler.dump_profile()
    finally:
        profiler.set_config()
    payload = json.loads(out.read_text())
    assert payload["embeddingStats"]["unique_ids"] == 2
    assert payload["commStats"]["pull"]["count"] >= 1
    with pytest.raises(ValueError):
        profiler.embedding_record(bogus=1)


@bounded
def test_push_update_parity_and_duplicate_combine(clusters):
    full = np.random.RandomState(1).randn(60, 8).astype(np.float32)
    ids = np.array([3, 7, 3, 0])
    g = np.random.RandomState(2).randn(4, 8).astype(np.float32)

    def run(c):
        c.kv.set_optimizer("sgd", learning_rate=1.0, rescale_grad=1.0)
        t = c.table(full=full)
        t.push(ids, g)
        c.kv.wait_outstanding()
        return t.as_dense()

    t, j = _both(clusters, run)
    _close(t, j)
    expect = full.copy()
    np.add.at(expect, ids, -g)
    _close(t, expect)


@bounded
def test_momentum_state_lives_server_side_at_one_over_n(clusters):
    def run(c):
        c.kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9,
                           rescale_grad=1.0)
        t = c.table()
        for _ in range(2):
            t.push(np.arange(10), np.ones((10, 8), np.float32))
        c.kv.wait_outstanding()
        return c.kv.server_memory(), t.as_dense()

    (tmem, tdense), (jmem, jdense) = _both(clusters, run)
    assert tmem == jmem
    per = [m["embed_store_bytes"] + m["embed_opt_bytes"] for m in tmem]
    assert all(m["embed_opt_bytes"] > 0 for m in tmem)
    for b in per:
        assert abs(b / sum(per) - 0.5) < 0.02
    _close(tdense, jdense)


@bounded
def test_oov_raises_typed_at_client_before_any_rpc(clusters):
    c = clusters("port")
    t = c.table(rows=20)
    profiler.comm_reset()
    with pytest.raises(EmbeddingShardError, match="out of vocabulary"):
        t.pull(np.array([0, 20]))
    with pytest.raises(EmbeddingShardError, match="out of vocabulary"):
        t.push(np.array([-1]), np.zeros((1, 8), np.float32))
    with pytest.raises(EmbeddingShardError, match="non-integral"):
        t.pull(np.array([0.5]))
    comm = profiler.comm_stats()
    assert comm.get("pull", {}).get("count", 0) == 0
    assert comm.get("push", {}).get("count", 0) == 0
    assert profiler.embedding_stats()["oov_errors"] >= 2


@bounded
def test_pull_batch_budget_splits_frames(clusters):
    def run(c, prof):
        t = c.table(rows=40, pull_batch=4)
        prof.comm_reset()
        _u, _i, vecs = t.pull(np.arange(40))
        return prof.comm_stats()["pull"]["count"], vecs

    (tn, tv), (jn, jv) = (run(clusters("port"), profiler),
                          run(clusters("jax"), jprof))
    assert tn == jn and tn >= 10
    np.testing.assert_array_equal(tv, jv)


@bounded
def test_naive_mode_is_per_id(clusters):
    c = clusters("port")
    t = c.table(rows=40, dedup=False)
    profiler.comm_reset()
    ids = np.array([1, 1, 5, 9])
    uniq, inverse, vecs = t.pull(ids)
    assert uniq.size == 4
    assert (inverse == np.arange(4)).all()
    assert profiler.comm_stats()["pull"]["count"] == 4
    np.testing.assert_array_equal(vecs, t.as_dense()[ids])


@bounded
def test_2bit_wire_error_feedback(clusters):
    def run(c):
        c.kv.set_optimizer("sgd", learning_rate=1.0, rescale_grad=1.0)
        t = c.table(rows=20, full=np.zeros((20, 8), np.float32),
                    wire="2bit", threshold=0.5)
        g = np.full((1, 8), 0.2, np.float32)
        t.push(np.array([3]), g)
        c.kv.wait_outstanding()
        first = t.as_dense()
        for _ in range(3):
            t.push(np.array([3, 5]), np.concatenate([g, -3 * g]))
        c.kv.wait_outstanding()
        return first, t.as_dense()

    (tf, td), (jf, jd) = _both(clusters, run)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(td, jd)
    assert np.allclose(tf[3], 0.0)
    assert not np.allclose(td[3], 0.0)
    steps = np.unique(np.abs(td[[3, 5]]))
    assert all(abs(s / 0.5 - round(s / 0.5)) < 1e-6 for s in steps)


# ---------------------------------------------------------------------------
# SparseEmbedding: the Gluon block over a table
# ---------------------------------------------------------------------------
def _sparse_embedding(c):
    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch import nd as tnd
    import mxnet_tpu as jmx

    if c.emb is temb:
        return temb.SparseEmbedding, tag, tnd
    return jemb.SparseEmbedding, jmx.autograd, jmx.nd


@bounded
def test_sparse_embedding_grad_parity(clusters):
    """One recorded batch with a repeated id, pushed by ``step``: the
    table moves by minus each row's summed gradient, in both packages."""
    def run(c):
        SparseEmbedding, autograd, nd = _sparse_embedding(c)
        c.kv.set_optimizer("sgd", learning_rate=1.0, rescale_grad=1.0)
        full = np.random.RandomState(2).randn(30, 4).astype(np.float32)
        emb = SparseEmbedding(4, 30, kvstore=c.kv, key="emb")
        emb.initialize_table(init_array=full)
        w = np.random.RandomState(3).randn(5, 4).astype(np.float32)
        ids = np.array([2, 9, 2, 17, 5], np.int64)
        with autograd.record():
            out = emb(nd.array(ids))
            loss = (out * nd.array(w)).sum()
        loss.backward()
        assert emb.step() == 1
        c.kv.wait_outstanding()
        expect = full.copy()
        np.add.at(expect, ids, -w)
        return emb.table.as_dense(), expect

    (tt, expect), (jt, _) = _both(clusters, run)
    np.testing.assert_allclose(tt, expect, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-5)


@bounded
def test_sparse_embedding_training_decreases_loss(clusters):
    """A small matrix factorization against a hidden low-rank model, full
    batch, the servers' sgd with momentum: the mse falls below a fifth of
    its start, along the JAX package's trajectory."""
    def run(c):
        SparseEmbedding, autograd, nd = _sparse_embedding(c)
        c.kv.set_optimizer("sgd", learning_rate=10.0, momentum=0.9,
                           rescale_grad=1.0)
        rng = np.random.RandomState(4)
        users, items = 40, 25
        gu = np.random.RandomState(10).randn(users, 6) * 0.5
        gv = np.random.RandomState(11).randn(items, 6) * 0.5
        eu = SparseEmbedding(6, users, kvstore=c.kv, key="u")
        ev = SparseEmbedding(6, items, kvstore=c.kv, key="v")
        eu.initialize_table(scale=0.2, seed=1)
        ev.initialize_table(scale=0.2, seed=2)
        u_ids = rng.randint(0, users, 200)
        i_ids = rng.randint(0, items, 200)
        ratings = (gu[u_ids] * gv[i_ids]).sum(axis=1).astype(np.float32)

        def mse():
            pred = (eu(nd.array(u_ids)) * ev(nd.array(i_ids))).sum(axis=1)
            return float(((pred.asnumpy() - ratings) ** 2).mean())

        curve = [mse()]
        for _ in range(40):
            with autograd.record():
                pred = (eu(nd.array(u_ids))
                        * ev(nd.array(i_ids))).sum(axis=1)
                diff = pred - nd.array(ratings)
                loss = (diff * diff).mean()
            loss.backward()
            eu.step()
            ev.step()
            c.kv.wait_outstanding()
            curve.append(mse())
        return np.asarray(curve)

    ours, theirs = _both(clusters, run)
    assert ours[-1] < ours[0] * 0.2, ours
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)


@bounded
def test_sparse_embedding_requires_kvstore():
    emb = temb.SparseEmbedding(4, 10, key="nokv")
    with pytest.raises(MXNetError, match="no kvstore bound"):
        emb(np.array([1]))


# ---------------------------------------------------------------------------
# the parts item 10's second part ported
# ---------------------------------------------------------------------------
def test_unported_parts_raise_by_name():
    """The lookup server and the table checkpoint were the parts that
    raised by name; both are ported."""
    from mxnet_tpu_torch.embedding import checkpoint, lookup

    # the lookup server is ported: a bad table is refused by its own check
    assert temb.EmbeddingLookupServer is lookup.EmbeddingLookupServer
    with pytest.raises(MXNetError, match="ShardedEmbeddingTable"):
        temb.EmbeddingTowerPredictor({"user": object()}, None)
    assert temb.elastic_table_checkpoint is \
        checkpoint.elastic_table_checkpoint
    assert "elastic_table_checkpoint" in temb.__all__


@bounded
def test_checkpoint_restores_exactly_the_servers_sub_keys(
        clusters, tmp_path, monkeypatch):
    """``elastic_table_checkpoint`` of a trained table, then a fresh server
    of each rank restores exactly its sub-key (its bytes the trained
    shard's) and that key's momentum, in both packages alike."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as tck

    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.delenv("MXNET_TPU_ZERO_SERVER", raising=False)
    restored = {}
    for pkg, ck_mod in (("port", tck), ("jax", jck)):
        c = clusters(pkg)
        c.kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9,
                           rescale_grad=1.0)
        full = np.random.RandomState(7).randn(40, 4).astype(np.float32)
        t = c.table(rows=40, dim=4, full=full)
        t.push(np.arange(12), np.ones((12, 4), np.float32))
        c.kv.wait_outstanding()
        trained = t.as_dense()
        mgr = ck_mod.CheckpointManager(str(tmp_path / pkg))
        fn = c.emb.elastic_table_checkpoint(mgr, [t], c.kv)
        assert fn(1) == 1
        ck = mgr.latest()
        assert ck.epoch == 1 and ck.worker_state(0)["epoch"] == 1
        restored[pkg] = {}
        for rank in range(2):
            fresh = tks.KVStoreServer(device="cpu") if pkg == "port" \
                else jks.KVStoreServer()
            try:
                n = fresh.restore_from_checkpoint(ck, shard_rank=rank,
                                                  num_shards=2)
                key = embedding_sub_key("emb", rank)
                other = embedding_sub_key("emb", 1 - rank)
                assert n == 1 and set(fresh._store) == {key}
                value = fresh._store[key]
                value = value.numpy() if pkg == "port" else value
                _close(value, trained[t.sharding.global_ids(rank)], key)
                states = fresh._updater.states
                assert key in states and other not in states
                mom = states[key]
                restored[pkg][rank] = (value, mom.asnumpy()
                                       if hasattr(mom, "asnumpy") else mom)
            finally:
                fresh.shutdown()
    for rank in range(2):
        for got, want in zip(restored["port"][rank], restored["jax"][rank]):
            _close(got, want, "rank %d" % rank)


def _heal_run(pkg, directory, monkeypatch, steps=12, crash_at=18):
    """An embedding regression on two servers of ``pkg`` with a tracker:
    a checkpoint after ``steps // 2`` steps, then ``server:0:crash@step=``
    ``crash_at`` (a server step is an applied push) stops server 0; a
    replacement restored from the checkpoint registers under rank 0 and
    the client's retry rediscovers it. The per-step losses, the crashes
    and the keys the replacement restored."""
    import threading

    if pkg == "port":
        from mxnet_tpu_torch import chaos, checkpoint as ck_mod, tracker
        make = lambda: tks.KVStoreServer(device="cpu")   # noqa: E731
        client, emb = tks.ServerKVStore, temb
    else:
        from mxnet_tpu import chaos, checkpoint as ck_mod, tracker
        make = jks.KVStoreServer
        client, emb = jks.ServerKVStore, jemb
    monkeypatch.setenv("MXNET_KVSTORE_RECONNECT_DEADLINE", "0.5")
    monkeypatch.setenv("MXNET_FAULT_SPEC", "server:0:crash@step=%d"
                       % crash_at)
    monkeypatch.setenv("DMLC_ROLE", "server")
    chaos.reset_engine()
    trk = tracker.Tracker(num_workers=1, num_servers=2, max_restarts=1)
    trk.serve_in_background()
    servers = [make(), make()]
    regs = []
    for rank, srv in enumerate(servers):
        srv.serve_in_background()
        regs.append(tracker.TrackerClient(trk.addr, "server", addr=srv.addr,
                                          rank=rank))
    wc = tracker.TrackerClient(trk.addr, "worker", rank=0)
    kv = client([s.addr for s in servers], tracker_client=wc)
    mgr = ck_mod.CheckpointManager(directory)
    crashed, healed = threading.Event(), {}

    def crash(_code):
        crashed.set()
        servers[0].shutdown()
        regs[0].close()

    chaos.engine()._exit = crash

    def respawn():
        crashed.wait(30)
        srv = make()
        healed["keys"] = srv.restore_from_checkpoint(
            mgr.latest(), shard_rank=0, num_shards=2)
        srv.serve_in_background()
        servers.append(srv)
        regs.append(tracker.TrackerClient(trk.addr, "server", addr=srv.addr,
                                          rank=0, restart_count=1))

    t = threading.Thread(target=respawn, daemon=True)
    t.start()
    try:
        kv.set_optimizer("sgd", learning_rate=0.5, rescale_grad=1.0)
        target = np.random.RandomState(3).randn(32, 4).astype(np.float32)
        table = emb.ShardedEmbeddingTable("emb", kv, 32, 4)
        table.init(init_array=np.zeros((32, 4), np.float32))
        ckpt = emb.elastic_table_checkpoint(mgr, [table], kv)
        ids = np.arange(32)
        losses = []
        def rows():
            uniq, inverse, vecs = table.pull(ids)
            return vecs[inverse]

        for step in range(steps):
            got = rows()
            losses.append(float(np.mean((got - target) ** 2)))
            table.push(ids, (got - target) / len(ids))
            kv.wait_outstanding()
            if step == steps // 2 - 1:
                ckpt(1)
        t.join(30)
        final = float(np.mean((rows() - target) ** 2))
        return losses, final, crashed.is_set(), healed.get("keys")
    finally:
        chaos.reset_engine()
        _stop(kv, *servers)
        for r in regs + [wc]:
            r.close()
        trk.shutdown()


@bounded
def test_chaos_embed_server_crash_heals(tmp_path, monkeypatch):
    """The chaos case of the embedding tier in one process, in both
    packages: server 0 crashes at its step, its replacement restores the
    checkpoint's sub-key (one key) and takes over under rank 0, the
    client's retries rediscover it, and the loss ends below where the
    checkpoint left it."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    for pkg in ("port", "jax"):
        losses, final, crashed, keys = _heal_run(pkg, str(tmp_path / pkg),
                                                 monkeypatch)
        assert crashed and keys == 1, (pkg, crashed, keys)
        assert losses[-1] < losses[0] and final < losses[6], (pkg, losses,
                                                              final)


def test_teardown_is_bounded():
    """The deadline helper fails a call that hangs."""
    import threading

    with pytest.raises(pytest.fail.Exception, match="did not return"):
        _within(0.2, threading.Event().wait)
