"""Embedding lookup serving (counterpart of
``mxnet_tpu/embedding/lookup.py``): sharded lookup + dense tower.

Requests carry raw id arrays; the :class:`EmbeddingTowerPredictor` pulls
the deduplicated rows from the tables row-sharded over the parameter
servers (``kvstore_server``) and feeds the gathered feature block through
a dense-tower :class:`~mxnet_tpu_torch.serving.AOTPredictor` (the gather
stays on the value servers, the tower runs on the predictor's device).
:class:`EmbeddingLookupServer` hosts it behind the dynamic-batching
:class:`ModelServer` and a fleet :class:`ReplicaServer` (the slot-free
``replica`` role when given a tracker), so a :class:`FleetRouter`
discovers, balances, drains and fails over lookup replicas like any
other serving replica.
"""
from __future__ import annotations

import numpy as np

from ..serving.broker import ModelServer
from ..serving.fleet import ReplicaServer
from ..serving.predictor import ServingError
from .table import ShardedEmbeddingTable

__all__ = ["EmbeddingTowerPredictor", "EmbeddingLookupServer"]


class EmbeddingTowerPredictor:
    """AOTPredictor-shaped adapter: id inputs -> sharded row pulls ->
    dense tower.

    ``tables`` is an ordered ``{input_name: ShardedEmbeddingTable}``
    mapping — requests carry one int id array per table, the looked-up
    vectors concatenate feature-wise (two-tower/MF serving shape) and
    feed the tower's single data input. Implements the predictor duck
    interface the broker's :class:`_ModelWorker` batches against
    (ladder / pick_bucket / data_names / _normalize / run_bucket /
    swap_params), so dynamic batching, padding, the executable LRU and
    hot swap all apply unchanged. Batch padding rows carry id 0 — a
    real row, pulled and discarded with the pad slice (never an OOV
    probe)."""

    def __init__(self, tables, tower):
        if not tables or not isinstance(tables, dict):
            raise ServingError(
                "EmbeddingTowerPredictor: tables must be a non-empty "
                "{input_name: ShardedEmbeddingTable} dict")
        for name, t in tables.items():
            if not isinstance(t, ShardedEmbeddingTable):
                raise ServingError(
                    "EmbeddingTowerPredictor: table %r is %r, not a "
                    "ShardedEmbeddingTable" % (name, type(t).__name__))
        self._tables = dict(tables)
        self._names = list(tables)
        self._tower = tower
        if len(tower.data_names) != 1:
            raise ServingError(
                "EmbeddingTowerPredictor: the dense tower must take "
                "ONE feature input, has %s" % tower.data_names)
        self._tower_input = tower.data_names[0]
        feat = sum(t.dim for t in self._tables.values())
        want = tower._data_shapes[self._tower_input]
        if len(want) != 2 or int(want[1]) != feat:
            raise ServingError(
                "EmbeddingTowerPredictor: tower input %r expects "
                "shape (n, %s) but the tables concatenate to %d "
                "features" % (self._tower_input, want[1:], feat))

    # -- predictor duck interface (broker.py _ModelWorker) -------------------
    @property
    def ladder(self):
        return self._tower.ladder

    @property
    def max_bucket(self):
        return self._tower.max_bucket

    @property
    def data_names(self):
        return list(self._names)

    @property
    def output_names(self):
        return self._tower.output_names

    def pick_bucket(self, rows):
        return self._tower.pick_bucket(rows)

    def _normalize(self, inputs):
        if not isinstance(inputs, dict):
            if len(self._names) != 1:
                raise ServingError(
                    "lookup model has id inputs %s: pass a "
                    "{name: id array} dict" % self._names)
            inputs = {self._names[0]: inputs}
        unknown = sorted(set(inputs) - set(self._names))
        missing = sorted(set(self._names) - set(inputs))
        if unknown or missing:
            raise ServingError(
                "bad request inputs: unknown %s, missing %s (id "
                "inputs: %s)" % (unknown, missing, self._names))
        out, rows = {}, None
        for name in self._names:
            v = np.asarray(inputs[name])
            if hasattr(inputs[name], "asnumpy"):
                v = inputs[name].asnumpy()
            # accept 1-D ids or a column/row vector of them: flatten
            # when at most one axis is non-unit. np.squeeze would
            # collapse a batch-of-one column vector (1, 1) to 0-d and
            # reject the same format that works at batch >= 2.
            if sum(1 for d in v.shape if d != 1) <= 1 and v.size:
                v = v.reshape(-1)
            if v.ndim != 1:
                raise ServingError(
                    "id input %r must be a 1-D id array, got shape %s"
                    % (name, tuple(np.asarray(inputs[name]).shape)))
            table = self._tables[name]
            # typed validation in the submitting thread: an
            # out-of-vocabulary id fails the caller before the request
            # ever occupies queue space
            v = table._check_ids(v, "lookup")
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise ServingError(
                    "id inputs disagree on the batch dim (%d vs %d)"
                    % (rows, int(v.shape[0])))
            out[name] = v
        if rows is None or rows < 1:
            raise ServingError("lookup request needs >= 1 id")
        return out, rows

    def run_bucket(self, inputs, bucket):
        feats = np.concatenate(
            [self._tables[n].lookup(inputs[n]) for n in self._names],
            axis=1)
        return self._tower.run_bucket({self._tower_input: feats}, bucket)

    def predict(self, inputs):
        """Synchronous single-request path (pads to the nearest
        bucket like AOTPredictor.predict)."""
        inputs, rows = self._normalize(inputs)
        bucket = self.pick_bucket(rows)
        if rows != bucket:
            inputs = {n: np.concatenate(
                [v, np.zeros((bucket - rows,), v.dtype)])
                for n, v in inputs.items()}
        outs = self.run_bucket(inputs, bucket)
        return [o[:rows] if o.ndim and o.shape[0] == bucket else o
                for o in outs]

    def swap_params(self, arg_params=None, aux_params=None,
                    allow_extra=False):
        """Hot-swap the TOWER weights (embedding rows update live
        through the training push path — there is nothing to swap
        table-side)."""
        return self._tower.swap_params(arg_params, aux_params,
                                       allow_extra=allow_extra)


class EmbeddingLookupServer:
    """A fleet-ready lookup replica: ModelServer hosting one
    :class:`EmbeddingTowerPredictor`, fronted by a
    :class:`~mxnet_tpu_torch.serving.fleet.ReplicaServer` (tracker-registered
    ``replica`` role when ``tracker_uri`` is given, so FleetRouter
    routes/drains/fails over it like any serving replica)."""

    def __init__(self, name, tables, tower, ladder=None,
                 tracker_uri=None, host="127.0.0.1", port=0, rank=None,
                 **server_kwargs):
        predictor = EmbeddingTowerPredictor(tables, tower)
        self._server = ModelServer(ladder=ladder or tower.ladder,
                                   **server_kwargs)
        self._server.add_model(name, predictor=predictor)
        self.name = name
        self.predictor = predictor
        self.replica = ReplicaServer(self._server,
                                     tracker_uri=tracker_uri,
                                     host=host, port=port, rank=rank)
        self.addr = self.replica.addr

    def serve_in_background(self):
        return self.replica.serve_in_background()

    def predict(self, inputs, timeout=None):
        """Local synchronous predict through the batching server."""
        return self._server.predict(self.name, inputs, timeout=timeout)

    def shutdown(self):
        self.replica.shutdown()

    def __enter__(self):
        self.serve_in_background()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
