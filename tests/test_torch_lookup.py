"""The port's embedding lookup server (``mxnet_tpu_torch/embedding/
lookup.py``) against the JAX package's, on the CPU: two in-process value
servers a package (``device="cpu"`` for the port's), tables holding the
same rows, towers holding the same weights.

- ``test_lookup_server_parity_and_fleet_routing`` and
  ``test_lookup_server_oov_typed`` of ``tests/test_embedding.py``: served
  scores equal the manual lookup + tower math (1-D ids, column vectors,
  batch of one), routed through a ``FleetRouter`` like any replica, and an
  out-of-vocabulary id raises the typed error in the submitting thread.
- The port's ``EmbeddingTowerPredictor`` against the JAX one on the same
  table rows and tower weights, through padding buckets; a pushed row
  changes the served score at once; and each package's router routes to
  the other package's lookup replica with the same scores.

Every test body runs under a deadline. Tolerance fp32: rtol 1e-4,
atol 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.embedding as jemb
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.embedding as temb
from mxnet_tpu import kvstore_server as jks
from mxnet_tpu.serving import AOTPredictor as JAOTPredictor
from mxnet_tpu.serving import FleetRouter as JFleetRouter
from mxnet_tpu_torch import kvstore_server as tks
from mxnet_tpu_torch.embedding import (EmbeddingLookupServer,
                                       EmbeddingShardError,
                                       EmbeddingTowerPredictor)
from mxnet_tpu_torch.serving import AOTPredictor, FleetRouter, ServingError

from torch_kvstore_helpers import _close, _stop, bounded

class _Cluster:
    """Two value servers and a client of one package."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.ks, self.emb = (tks, temb) if pkg == "port" else (jks, jemb)
        self.servers = [tks.KVStoreServer(device="cpu") if pkg == "port"
                        else jks.KVStoreServer(num_workers=1)
                        for _ in range(2)]
        for s in self.servers:
            s.serve_in_background()
        self.kv = self.ks.ServerKVStore(
            ",".join(s.addr for s in self.servers))

    def table(self, key, rows, dim, full):
        t = self.emb.ShardedEmbeddingTable(key, self.kv, rows, dim)
        t.init(init_array=full)
        return t

    def tower(self, feat_dim, w, b, ladder=(1, 4, 16)):
        mx = tmx if self.pkg == "port" else jmx
        sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=1,
                                    name="fc")
        params = {"fc_weight": w, "fc_bias": b}
        if self.pkg == "port":
            return AOTPredictor(sym, params,
                                data_shapes={"data": (1, feat_dim)},
                                ladder=ladder, device="cpu")
        return JAOTPredictor(sym, {k: jmx.nd.array(v)
                                   for k, v in params.items()},
                             data_shapes={"data": (1, feat_dim)},
                             ladder=ladder)

    def close(self):
        _stop(self.kv, *self.servers)


@pytest.fixture
def clusters():
    made = []

    def make(pkg):
        made.append(_Cluster(pkg))
        return made[-1]

    yield make
    for c in made:
        c.close()


def _rows(seed, rows, dim):
    return np.random.RandomState(seed).randn(rows, dim).astype(np.float32)


@bounded
def test_lookup_server_parity_and_fleet_routing(clusters):
    c = clusters("port")
    tu = c.table("lu", 30, 4, _rows(3, 30, 4))
    ti = c.table("li", 20, 4, _rows(4, 20, 4))
    w = np.random.RandomState(5).randn(1, 8).astype(np.float32)
    b = np.zeros((1,), np.float32)
    with EmbeddingLookupServer("mf", {"user": tu, "item": ti},
                               c.tower(8, w, b)) as srv:
        u = np.array([1, 5, 7])
        it = np.array([0, 3, 19])
        outs = srv.predict({"user": u, "item": it})
        feats = np.concatenate([tu.lookup(u), ti.lookup(it)], axis=1)
        expect = feats @ w.T + b
        _close(outs[0], expect)
        col = srv.predict({"user": u.reshape(-1, 1),
                           "item": it.reshape(-1, 1)})
        _close(col[0], expect)
        one = srv.predict({"user": np.array([[1]]),
                           "item": np.array([[0]])})
        _close(one[0], expect[:1])
        with FleetRouter(replicas=[srv.addr], view_interval=0.5,
                         timeout=10.0) as router:
            r = router.request("mf", {"user": u, "item": it})
            _close(r[0], expect)


@bounded
def test_lookup_server_oov_typed(clusters):
    c = clusters("port")
    tu = c.table("lo", 10, 4, _rows(6, 10, 4))
    w = np.zeros((1, 4), np.float32)
    b = np.zeros((1,), np.float32)
    with EmbeddingLookupServer("m1", {"user": tu},
                               c.tower(4, w, b)) as srv:
        with pytest.raises(EmbeddingShardError, match="out of vocab"):
            srv.predict({"user": np.array([11])})
        with pytest.raises(ServingError, match="1-D id array"):
            srv.predict({"user": np.array([[1, 2], [3, 4]])})


@bounded
def test_tower_predictor_matches_jax(clusters):
    full_u, full_i = _rows(7, 50, 6), _rows(8, 40, 2)
    w = np.random.RandomState(9).randn(1, 8).astype(np.float32)
    b = np.array([0.25], np.float32)
    preds, tables = {}, {}
    for pkg in ("port", "jax"):
        c = clusters(pkg)
        tables[pkg] = (c.table("u", 50, 6, full_u),
                       c.table("i", 40, 2, full_i))
        preds[pkg] = c.emb.EmbeddingTowerPredictor(
            {"user": tables[pkg][0], "item": tables[pkg][1]},
            c.tower(8, w, b))
    assert preds["port"].data_names == preds["jax"].data_names
    assert preds["port"].ladder == tuple(preds["jax"].ladder)
    rng = np.random.RandomState(10)
    for n in (1, 3, 4, 7, 16):
        req = {"user": rng.randint(0, 50, n), "item": rng.randint(0, 40, n)}
        got = preds["port"].predict(req)
        want = preds["jax"].predict(req)
        assert len(got) == len(want) == 1
        _close(got[0], np.asarray(want[0]), "rows %d" % n)
    # a pushed row changes the served score at once (online rows)
    for pkg in ("port", "jax"):
        tables[pkg][0]._kv.set_optimizer("sgd", learning_rate=1.0,
                                         rescale_grad=1.0)
    req = {"user": np.array([2, 2, 9]), "item": np.array([0, 1, 2])}
    before = preds["port"].predict(req)[0]
    for pkg in ("port", "jax"):
        tables[pkg][0].push(np.array([2]), np.ones((1, 6), np.float32))
        tables[pkg][0]._kv.wait_outstanding()
    after = preds["port"].predict(req)[0]
    assert not np.allclose(after[:2], before[:2])
    _close(after[2], before[2])
    _close(after, np.asarray(preds["jax"].predict(req)[0]))
    with pytest.raises(ServingError, match="ShardedEmbeddingTable"):
        EmbeddingTowerPredictor({"user": tables["jax"][0]},
                                preds["port"]._tower)
    with pytest.raises(ServingError, match="concatenate"):
        EmbeddingTowerPredictor({"user": tables["port"][0]},
                                preds["port"]._tower)


@bounded
def test_routers_of_either_package_route_to_either_lookup_replica(clusters):
    full_u = _rows(11, 25, 4)
    w = np.random.RandomState(12).randn(1, 4).astype(np.float32)
    b = np.zeros((1,), np.float32)
    servers = {}
    for pkg in ("port", "jax"):
        c = clusters(pkg)
        servers[pkg] = c.emb.EmbeddingLookupServer(
            "rec", {"user": c.table("u", 25, 4, full_u)}, c.tower(4, w, b))
        servers[pkg].serve_in_background()
    try:
        ids = np.array([0, 4, 24, 7])
        want = full_u[ids] @ w.T + b
        for router_cls in (FleetRouter, JFleetRouter):
            for pkg in ("port", "jax"):
                with router_cls(replicas=[servers[pkg].addr],
                                view_interval=0.5, timeout=10.0) as router:
                    got = router.request("rec", {"user": ids})
                    _close(got[0], want, "%s -> %s" % (router_cls, pkg))
    finally:
        for srv in servers.values():
            srv.shutdown()
