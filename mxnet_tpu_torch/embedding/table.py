"""Server-sharded embedding tables (counterpart of
``mxnet_tpu/embedding/table.py``).

:class:`ShardedEmbeddingTable` is the client handle on one embedding table
whose rows live as dense sub-tables across the parameter servers: row shard
``s`` (``sharding.RowSharding``) is the key ``<key>@embshard<s>`` on server
``s % num_servers``. A pull asks for the deduplicated ids in one
``row_pull`` frame a shard (at most ``MXNET_EMBED_PULL_BATCH`` rows a
frame), the shards fetched concurrently; a push sends row-granular
gradient scatters, duplicates combined first, through the client's sender
pipeline, optionally as 2-bit codes with per-row error-feedback residuals.
A server holds its sub-tables and the optimizer state beside them on its
device: about 1/num_servers of the table each.

Out-of-vocabulary ids raise :class:`EmbeddingShardError` at the client,
before any RPC: the table never clamps.
"""
from __future__ import annotations

import time

import numpy as np

from .. import config
from .. import profiler
from ..base import MXNetError
from ..kvstore import two_bit_quantize
from ..kvstore_server import ServerKVStore, embedding_sub_key
from .sharding import RowSharding

__all__ = ["EmbeddingShardError", "ShardedEmbeddingTable"]


class EmbeddingShardError(MXNetError):
    """Typed embedding-table failure: out-of-vocabulary row ids or a
    sharding/topology misconfiguration. Raised client-side so the
    caller that produced the bad ids sees it — never a silent clamp,
    never a server-side-only error."""


def _knob_shards(num_servers, override):
    if override is not None:
        n = int(override)
    else:
        n = config.get_nonneg_int("MXNET_EMBED_SHARDS")
    if n == 0:
        n = int(num_servers)
    if n < 1:
        raise EmbeddingShardError(
            "ShardedEmbeddingTable: shard count must be >= 1, got %d"
            % n)
    return n


class ShardedEmbeddingTable:
    """Client handle on one server-sharded embedding table.

    ::

        kv = mx.kv.create("dist_async")          # MXNET_PS_SERVER_URI set
        kv.set_optimizer("sgd", learning_rate=0.05)
        table = ShardedEmbeddingTable("user_emb", kv, rows=1 << 20,
                                      dim=64)
        table.init()                             # first-writer-wins
        uniq, inverse, vecs = table.pull(ids)    # dedup pull
        table.push(uniq, row_grads)              # async scatter push

    ``dedup=False`` (or ``MXNET_EMBED_DEDUP=0``) switches pulls to the
    naive one-RPC-per-id baseline the bench variant compares against.
    """

    def __init__(self, key, kvstore, rows, dim, dtype="float32",
                 num_shards=None, dedup=None, pull_batch=None,
                 wire=None, threshold=None):
        if not isinstance(kvstore, ServerKVStore):
            raise EmbeddingShardError(
                "ShardedEmbeddingTable needs the dist_async server "
                "tier (ServerKVStore), got %r" % type(kvstore).__name__)
        self.key = str(key)
        self._kv = kvstore
        self.rows = int(rows)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        if self.dim < 1:
            raise EmbeddingShardError(
                "ShardedEmbeddingTable %r: dim must be >= 1, got %d"
                % (self.key, self.dim))
        self.sharding = RowSharding(
            self.rows, _knob_shards(kvstore.num_servers, num_shards))
        # strict knob reads happen unconditionally (a typo'd knob is a
        # job misconfiguration, not a silent default) even when the
        # ctor argument overrides them
        env_dedup = config.get_strict_bool("MXNET_EMBED_DEDUP")
        self.dedup = env_dedup if dedup is None else bool(dedup)
        env_batch = config.get_positive_int("MXNET_EMBED_PULL_BATCH")
        self.pull_batch = env_batch if pull_batch is None \
            else int(pull_batch)
        if self.pull_batch < 1:
            raise EmbeddingShardError(
                "ShardedEmbeddingTable %r: pull_batch must be >= 1, "
                "got %d" % (self.key, self.pull_batch))
        env_wire = config.get_choice("MXNET_EMBED_WIRE", ("raw", "2bit"))
        self.wire = env_wire if wire is None else str(wire)
        if self.wire not in ("raw", "2bit"):
            raise EmbeddingShardError(
                "ShardedEmbeddingTable %r: wire must be raw|2bit, got "
                "%r" % (self.key, self.wire))
        env_thr = config.get_positive_float("MXNET_EMBED_WIRE_THRESHOLD")
        self.threshold = env_thr if threshold is None \
            else float(threshold)
        self._residuals = {}  # global row id -> error-feedback vector
        self._sub_keys = self.sharding.sub_keys(self.key)
        self._pull_pool = None  # lazy per-shard fetch pool

    def _pool(self):
        if self._pull_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pull_pool = ThreadPoolExecutor(
                max_workers=min(self.num_shards, 8),
                thread_name_prefix="embed-pull-%s" % self.key)
        return self._pull_pool

    # -- topology ------------------------------------------------------------
    @property
    def num_shards(self):
        return self.sharding.num_shards

    def server_of(self, shard):
        """The kvstore server rank hosting row shard ``shard`` (the
        suffix routing rule, shared with a respawned server's
        ``restore_from_checkpoint``)."""
        return int(shard) % self._kv.num_servers

    # -- init ----------------------------------------------------------------
    def init(self, init_array=None, scale=None, seed=0):
        """Install the sub-tables on their servers (first-writer-wins,
        like every kvstore init — a respawned or late-joining worker's
        init never overwrites trained/restored rows). ``init_array``
        (rows, dim) scatters an explicit table (tests, warm starts);
        otherwise each sub-table fills uniform(-scale, scale) from a
        deterministic per-shard seed, so every worker offers identical
        bytes and the first-writer race is invisible."""
        if scale is None:
            scale = 1.0 / np.sqrt(self.dim)
        if init_array is not None:
            init_array = np.asarray(init_array, self.dtype)
            if init_array.shape != (self.rows, self.dim):
                raise EmbeddingShardError(
                    "init_array shape %s != (%d, %d)"
                    % (init_array.shape, self.rows, self.dim))
        for s in range(self.num_shards):
            n = self.sharding.shard_rows(s)
            if init_array is not None:
                sub = init_array[self.sharding.global_ids(s)]
            else:
                rng = np.random.RandomState(
                    (int(seed) * 1000003 + s) % (1 << 31))
                sub = rng.uniform(-scale, scale,
                                  (n, self.dim)).astype(self.dtype)
            self._kv._rpc_idx(self.server_of(s), "init",
                              self._sub_keys[s], None,
                              _arr_to_wire_np(sub))

    # -- validation ----------------------------------------------------------
    def _check_ids(self, ids, what):
        ids = np.ascontiguousarray(np.asarray(ids)).reshape(-1)
        if ids.size == 0:
            return ids.astype(np.int64)
        if not np.issubdtype(ids.dtype, np.number):
            raise EmbeddingShardError(
                "%s %r: row ids must be numeric, got dtype %s"
                % (what, self.key, ids.dtype))
        ids64 = ids.astype(np.int64)
        if np.issubdtype(ids.dtype, np.floating) \
                and not np.array_equal(ids64, ids):
            raise EmbeddingShardError(
                "%s %r: non-integral row ids" % (what, self.key))
        lo, hi = int(ids64.min()), int(ids64.max())
        if lo < 0 or hi >= self.rows:
            profiler.embedding_record(oov_errors=1)
            raise EmbeddingShardError(
                "%s %r: row ids out of vocabulary: [%d, %d] vs %d "
                "rows (ids are validated at the client — fix the id "
                "producer; the table never clamps)"
                % (what, self.key, lo, hi, self.rows))
        return ids64

    # -- read path -----------------------------------------------------------
    def pull(self, ids):
        """Rows for (possibly repeated) global ids. Returns
        ``(unique_ids, inverse, vectors)`` with
        ``vectors[inverse].reshape(ids.shape + (dim,))`` the per-id
        lookup; with dedup off (the naive baseline) ``unique_ids`` is
        the flattened request itself and ``inverse`` the identity."""
        t0 = time.perf_counter()
        flat = self._check_ids(ids, "pull")
        if self.dedup:
            uniq, inverse = np.unique(flat, return_inverse=True)
        else:
            uniq, inverse = flat, np.arange(flat.size, dtype=np.int64)
        vecs = np.empty((uniq.size, self.dim), self.dtype)
        nbytes = {}
        if uniq.size:
            if self.dedup:
                groups = self.sharding.group(uniq)

                def _fetch(s, sel, loc):
                    srv = self.server_of(s)
                    moved = 0
                    for ofs in range(0, loc.size, self.pull_batch):
                        block = self._kv.row_pull(
                            srv, self._sub_keys[s],
                            loc[ofs:ofs + self.pull_batch])
                        # disjoint slices of vecs: safe to fill
                        # concurrently
                        vecs[sel[ofs:ofs + self.pull_batch]] = block
                        moved += int(block.nbytes)
                    return s, moved

                if len(groups) > 1:
                    # the per-shard frames are independent RPCs to
                    # different sockets: fetched concurrently, a read
                    # takes about one round trip whatever the server
                    # count
                    for s, moved in self._pool().map(
                            lambda g: _fetch(*g), groups):
                        nbytes[s] = nbytes.get(s, 0) + moved
                else:
                    for g in groups:
                        s, moved = _fetch(*g)
                        nbytes[s] = nbytes.get(s, 0) + moved
            else:
                # the naive baseline (MXNET_EMBED_DEDUP=0): one RPC per
                # requested id
                shards, locals_ = self.sharding.shard_and_local(uniq)
                for i in range(uniq.size):
                    s = int(shards[i])
                    block = self._kv.row_pull(
                        self.server_of(s), self._sub_keys[s],
                        locals_[i:i + 1])
                    vecs[i] = block[0]
                    nbytes[s] = nbytes.get(s, 0) + int(block.nbytes)
        profiler.embedding_record(
            pulls=1, ids_requested=int(flat.size),
            unique_ids=int(uniq.size), rows_pulled=int(uniq.size),
            pull_seconds=time.perf_counter() - t0, shard_bytes=nbytes,
            pull_latencies=[time.perf_counter() - t0])
        return uniq, inverse, vecs

    def lookup(self, ids):
        """Per-id vectors in request shape + (dim,) — the serving-path
        convenience over :meth:`pull`."""
        ids_arr = np.asarray(ids)
        uniq, inverse, vecs = self.pull(ids_arr)
        return vecs[inverse].reshape(tuple(ids_arr.shape) + (self.dim,))

    # -- write path ----------------------------------------------------------
    def push(self, ids, grads, priority=0):
        """Push per-row gradients for global ids (duplicates combine
        client-side by summation — the scatter-add the server would
        otherwise repeat) as async row scatters, one frame per touched
        shard, on the kvstore sender pipeline. With ``wire='2bit'``
        the row block quantizes through the packed two-bit
        quantizer, with a per-row error-feedback residual held here
        (memory grows with the rows THIS worker touches — the table's
        working set, not its vocabulary)."""
        t0 = time.perf_counter()
        flat = self._check_ids(ids, "push")
        grads = np.ascontiguousarray(
            np.asarray(grads, self.dtype)).reshape(flat.size, self.dim)
        if flat.size == 0:
            return
        uniq, inverse = np.unique(flat, return_inverse=True)
        if uniq.size != flat.size:
            agg = np.zeros((uniq.size, self.dim), self.dtype)
            np.add.at(agg, inverse, grads)
            grads = agg
        nbytes = {}
        for s, sel, loc in self.sharding.group(uniq):
            block = grads[sel]
            compressed = None
            if self.wire == "2bit":
                block, compressed = self._compress_rows(uniq[sel], block)
            else:
                # the fancy-index slice above is already a private
                # copy this table owns: mark it read-only so row_push
                # skips its defensive pipeline snapshot (one copy, not
                # two, per pushed shard block)
                block.flags.writeable = False
            self._kv.row_push(self.server_of(s), self._sub_keys[s],
                              loc, block, priority=priority,
                              compressed=compressed)
            nbytes[s] = nbytes.get(s, 0) + int(
                compressed[0].nbytes if compressed else block.nbytes)
        profiler.embedding_record(
            pushes=1, rows_pushed=int(uniq.size),
            push_seconds=time.perf_counter() - t0, shard_bytes=nbytes,
            push_latencies=[time.perf_counter() - t0])

    def _compress_rows(self, global_ids, block):
        """2-bit wire treatment of one shard's row block: per-row
        error-feedback residuals keyed by GLOBAL id (rows migrate
        between push rounds' shard groupings only if the topology
        changes, which resets the table anyway)."""
        res = np.zeros_like(block)
        for i, gid in enumerate(global_ids):
            r = self._residuals.get(int(gid))
            if r is not None:
                res[i] = r
        packed, new_res = two_bit_quantize(block, res, self.threshold)
        for i, gid in enumerate(global_ids):
            self._residuals[int(gid)] = new_res[i]
        return block, (packed, self.threshold)

    def reset_residuals(self):
        """Drop the 2-bit error-feedback residuals (the rollback rule:
        accumulated error refers to pre-rollback weights)."""
        self._residuals = {}

    # -- checkpoint / introspection -----------------------------------------
    def snapshot(self):
        """{sub_key: full sub-table numpy array} — the quiesced rank-0
        read of the checkpoint choreography (each sub-key is a plain
        dense key; the pull drains this client's pipeline first)."""
        self._kv.wait_outstanding()
        out = {}
        for s in range(self.num_shards):
            k = self._sub_keys[s]
            wire = self._kv._rpc_idx(self.server_of(s), "pull", k)
            from ..kvstore_server import _arr_from_wire

            out[k] = np.asarray(_arr_from_wire(wire))
        return out

    def as_dense(self):
        """The full logical (rows, dim) table reassembled from the
        shard snapshots — tests and small-table exports only."""
        snap = self.snapshot()
        dense = np.empty((self.rows, self.dim), self.dtype)
        for s in range(self.num_shards):
            dense[self.sharding.global_ids(s)] = snap[self._sub_keys[s]]
        return dense

    def server_memory(self):
        """Per-server measured table+optimizer bytes (rank order)."""
        return self._kv.server_memory()


def _arr_to_wire_np(a):
    from ..kvstore_server import _arr_to_wire

    return _arr_to_wire(np.ascontiguousarray(a))
