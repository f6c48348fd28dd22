"""The parameter-server tier on one host (counterpart of
``mxnet_tpu/kvstore_server.py``): ``KVStoreServer`` holds the weights and
runs the optimizer server-side, ``ServerKVStore`` is its client.

``KVStoreServer`` answers over TCP: ``init`` is first-writer-wins, each
``push`` is applied on arrival under the server's updater (the dist_async
contract: no global synchronisation, pulls return the freshest weights), a
row-scatter push runs the lazy row-sparse update on the pushed rows only,
``pull``/``row_pull`` return the weights or the asked rows, ``barrier``
blocks (by name, with a timeout) until every worker arrives. A push
carries a ``(client id, seqno)`` pair the server claims before applying
it, so a retried push is acked without being applied twice.

The stored values and the optimizer's states live on the server's device
as torch tensors: ``cuda`` unless the server is built with
``device="cpu"``. A push updates the stored tensor in place (the pushed
rows only, for a row scatter); a pull or a ``row_pull`` copies to the host
only what it sends, under the lock. The values, and the bytes
``memory_bytes`` counts, are the JAX package's, which keeps host numpy
arrays and sends each whole array through its device for every update.

``ServerKVStore`` routes keys to servers by a stable hash (crc32), and
embedding sub-tables (``<key>@embshard<s>``) to server ``s % n``. Its
pushes go through one sender thread a server (priority order, coalesced
``push_multi`` frames; ``MXNET_KVSTORE_PIPELINE=0`` or ``pipeline=False``
for the synchronous client), a pull waits only for its own keys' pushes,
and an RPC that fails on the transport is retried over a new connection to
the same URI. ``set_gradient_compression`` ships dense pushes as packed
2-bit codes with an error-feedback residual.

The wire is the JAX package's, byte for byte (``tracker.py``'s frames;
arrays as ``(dtype, shape, bytes)``, large ones out of band; optimizer
states as tagged plain data, never a pickle): each package's client
drives the other's servers.

Recovery: ``KVStoreServer.restore_from_checkpoint`` preloads a server's
own key shard (weights and optimizer state) from a committed checkpoint,
the ``rollback`` op (``ServerKVStore.rollback_servers``) reloads it in
place from the server's ``MXNET_CHECKPOINT_DIR`` with an lr backoff
applied once a generation, elastic barriers (``MXNET_MAX_RESTARTS > 0``)
retract a dead waiter's arrival instead of aborting the round, and a
client given ``tracker_client=`` rediscovers a respawned server's new
address. The chaos hooks fire where the JAX package fires them: a server
step is an applied push, ``rpc:drop`` on either side of the wire.

ZeRO value sharding (``MXNET_TPU_ZERO_SERVER=1`` with more than one
server): each dense float key of at least ``MXNET_TPU_ZERO_MIN_SIZE``
elements is split into contiguous flat slices, one a server
(``zero_slice_sizes``); the client scatters each push and gathers each
pull, a server updates its slice (and holds its slice of the optimizer
state) like any key, ``save_optimizer_states`` joins the slices whole and
``load_optimizer_states`` splits them for the servers it has;
``restore_from_checkpoint`` takes this server's slice.

``python -m mxnet_tpu_torch.kvstore_server`` is the entry point the
launchers start (``DMLC_ROLE``): the scheduler role runs the tracker, the
server role (``MXNET_KVSTORE_SERVER=1``) binds ``MXNET_PS_BIND_HOST``/
``PORT``, keeps its store on the card (``MXNET_PS_SERVER_DEVICE=cpu`` in
its environment for the CPU), restores from ``MXNET_CHECKPOINT_DIR``'s
newest checkpoint before it registers with the tracker (as
``DMLC_SERVER_ID``, with its restart count, at ``MXNET_PS_ADVERTISE_HOST``
when set) and serves; any other role exits 0. In-cluster protocol with no auth: do not expose the port beyond
the job.
"""
from __future__ import annotations

import heapq
import os
import pickle
import re
import socket
import threading
import time
import uuid
import warnings
import zlib
from collections import deque

import numpy as np
import torch

from . import chaos
from . import config
from . import kvstore
from . import profiler
from .base import MXNetError
from .context import Context, resolve_device
from .kvstore import (two_bit_dequantize, two_bit_quantize,
                      validate_compression_params)
from .ndarray.ndarray import NDArray
from .tracker import (TrackerError, _env_count,  # noqa: F401
                      _SafeUnpickler, _pack, _recv_msg, _send_msg, _unpack,
                      connect_with_backoff, env_nonneg_int,
                      env_positive_float, prune_barrier_names)

def shard_key(key, num_shards):
    """key -> server index, stable across processes (crc32, not the salted
    builtin hash)."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(str(key).encode()) % num_shards


# an embedding table's row shard s is the dense sub-table
# ``<key>@embshard<s>`` on server ``s % num_servers``
_EMBED_SHARD_RE = re.compile(r"@embshard(\d+)$")


def embedding_sub_key(key, shard):
    """The dense sub-table key holding row shard ``shard`` of the sharded
    embedding table ``key``."""
    return "%s@embshard%d" % (key, int(shard))


def embedding_shard_rank(key):
    """The row-shard index an embedding sub-key encodes, or None for
    ordinary keys."""
    m = _EMBED_SHARD_RE.search(str(key))
    return int(m.group(1)) if m else None


def zero_slice_sizes(size, num_shards):
    """Contiguous slice lengths of ``size`` elements over ``num_shards``
    (the first ``size % n`` slices get one extra): the ZeRO value split
    and the embedding table's range split."""
    base, extra = divmod(int(size), int(num_shards))
    return [base + (1 if i < extra else 0) for i in range(num_shards)]


def zero_value_sharded(arr, num_shards, min_size):
    """True when a key's dense array is split over the servers: floating,
    at least ``min_size`` (and ``num_shards``) elements."""
    return (num_shards > 1 and getattr(arr, "ndim", 0) >= 1
            and np.issubdtype(arr.dtype, np.floating)
            and arr.size >= max(int(min_size), num_shards))


def zero_slice_pytree(state, sizes, idx):
    """Server ``idx``'s slice of one key's state: each array leaf of the
    key's whole size becomes its contiguous flat range by ``sizes``;
    lists and tuples recurse; scalars and None (the same on every server)
    stay. The one split rule of the clients and of a restoring server."""
    bounds = np.cumsum([0] + list(sizes))
    total = int(bounds[-1])

    def part(x):
        if isinstance(x, np.ndarray) and x.size == total:
            return np.ascontiguousarray(
                x.reshape(-1)[bounds[idx]:bounds[idx + 1]])
        if isinstance(x, (list, tuple)):
            return type(x)(part(i) for i in x)
        return x

    return part(state)


class _RPCTransportError(Exception):
    """Transport failure (reset, timeout): retriable, unlike an
    ``('err', ...)`` reply."""


#: arrays of at least this many bytes travel as out-of-band buffers
_OOB_MIN_BYTES = 2048


def _arr_to_wire(a, zero_copy=False):
    a = np.ascontiguousarray(a)
    if zero_copy and a.nbytes >= _OOB_MIN_BYTES:
        # the caller owns ``a`` as a stable snapshot
        return (str(a.dtype), a.shape, pickle.PickleBuffer(a))
    return (str(a.dtype), a.shape, a.tobytes())


def _arr_from_wire(w):
    dtype, shape, raw = w
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    # out-of-band frames land in bytearrays we own: already writable
    return arr if arr.flags.writeable else arr.copy()


#: compressed-push wire tag; never a numpy dtype name
_2BIT_TAG = "2bit"
#: row-scatter push wire tag: (ids, per-row gradient block)
_ROW_TAG = "rows"


def _grad_to_wire(arr, compressed=None):
    """Dense gradient -> wire entry; ``compressed`` is the ``(packed,
    threshold)`` pair of ``two_bit_quantize``, None ships raw."""
    if compressed is None:
        return _arr_to_wire(arr, zero_copy=True)
    packed, threshold = compressed
    payload = pickle.PickleBuffer(packed) \
        if packed.nbytes >= _OOB_MIN_BYTES else packed.tobytes()
    return (_2BIT_TAG, str(arr.dtype), tuple(arr.shape), float(threshold),
            payload)


class _RowScatter:
    """A decoded row-scatter push: ``values[i]`` is the gradient of row
    ``ids[i]`` of the stored table."""

    __slots__ = ("ids", "values")

    def __init__(self, ids, values):
        self.ids = ids
        self.values = values


def _rows_to_wire(ids, values, compressed=None):
    return (_ROW_TAG,
            _arr_to_wire(np.ascontiguousarray(ids, dtype=np.int64)),
            _grad_to_wire(values, compressed))


def _grad_from_wire(w):
    """Wire entry -> dense gradient (2-bit payloads dequantized) or a
    :class:`_RowScatter`."""
    if w and w[0] == _ROW_TAG:
        _tag, ids_w, vals_w = w
        return _RowScatter(_arr_from_wire(ids_w), _grad_from_wire(vals_w))
    if w and w[0] == _2BIT_TAG:
        _tag, dtype, shape, threshold, raw = w
        return two_bit_dequantize(raw, shape, dtype, threshold)
    return _arr_from_wire(w)


def _chaos_op(op):
    """The base op whose fault rules a coalesced or row frame answers to
    (``rpc:drop@op=push`` covers the pipelined client's ``push_multi``)."""
    return {"push_multi": "push", "pull_multi": "pull",
            "row_pull": "pull"}.get(op, op)


def _state_to_wire(v):
    """Optimizer-state pytree -> tagged plain data (arrays as
    ``(dtype, shape, bytes)``), never a pickle blob."""
    if v is None:
        return ("none",)
    if isinstance(v, (bool, int, float, str)):
        return ("py", v)
    if isinstance(v, (list, tuple)):
        tag = "list" if isinstance(v, list) else "tuple"
        return (tag, [_state_to_wire(i) for i in v])
    arr = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
    return ("nd",) + _arr_to_wire(arr)


def _state_from_wire(w):
    tag = w[0]
    if tag == "none":
        return None
    if tag == "py":
        return w[1]
    if tag == "list":
        return [_state_from_wire(i) for i in w[1]]
    if tag == "tuple":
        return tuple(_state_from_wire(i) for i in w[1])
    if tag == "nd":
        return _arr_from_wire(w[1:])
    raise ValueError("bad optimizer-state wire tag %r" % (tag,))


def _nbytes(t):
    return int(t.numel()) * t.element_size()


def _host(t):
    """A host numpy copy of ``t`` that nothing else aliases."""
    return t.detach().to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class KVStoreServer:
    """Weights and the server-side optimizer behind a TCP endpoint, on
    ``device`` (``cuda`` by default)."""

    def __init__(self, host="127.0.0.1", port=0, num_workers=1,
                 barrier_timeout=None, elastic=None, device=None):
        self._device = resolve_device(device)
        self._ctx = Context.from_device(self._device)
        self._store = {}            # key -> torch.Tensor on the device
        self._updater = None
        self._opt_config = None
        self._lock = threading.Lock()
        self._num_workers = num_workers
        self._barrier_cond = threading.Condition()
        # named rounds: arrivals at different names never pair
        self._barriers = {}         # name -> {"count": int, "gen": int}
        self._barrier_errors = {}   # (name, gen) -> abort message
        # client id -> (claimed seqnos, their order): the retry dedupe
        self._seen = {}
        self._seen_lock = threading.Lock()
        self._pushes_applied = 0
        self._rollback_gen = -1  # the newest applied rollback generation
        if elastic is None:
            elastic = env_nonneg_int("MXNET_MAX_RESTARTS") > 0
        #: a worker dying mid-barrier retracts its own arrival (its respawn
        #: arrives again) instead of aborting the round for the survivors
        self._elastic = bool(elastic)
        if barrier_timeout is None:
            barrier_timeout = env_positive_float(
                "MXNET_KVSTORE_BARRIER_TIMEOUT")
        self._barrier_timeout = float(barrier_timeout)
        self._conns = set()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr = "%s:%d" % self._sock.getsockname()[:2]

    @property
    def device(self):
        return self._device

    def _tensor(self, arr, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=self._device, dtype=dtype or t.dtype)

    # -- op handlers --------------------------------------------------------
    def _apply_push(self, key, grad):
        with self._lock:
            if key not in self._store:
                raise KeyError("push before init: %r" % (key,))
            if isinstance(grad, _RowScatter):
                self._apply_row_scatter_locked(key, grad)
            elif self._updater is None:
                self._store[key] += self._tensor(grad)
            else:
                from .ndarray.ndarray import array

                w = NDArray(self._store[key], self._ctx)
                self._updater(key, array(grad, ctx=self._ctx), w)
            self._pushes_applied += 1
        # a server step of MXNET_FAULT_SPEC is one applied push; outside
        # the lock, so an injected exit never dies holding it
        chaos.tick_step()

    def _apply_row_scatter_locked(self, key, scatter):
        """A row-granular gradient: the server's optimizer runs its lazy
        row-sparse update, so only the pushed rows (and their rows of the
        optimizer state) move. An id out of range errs the whole push."""
        from .ndarray import sparse

        store = self._store[key]
        ids = np.asarray(scatter.ids, np.int64)
        vals = np.asarray(scatter.values)
        if vals.shape[:1] != ids.shape or \
                vals.shape[1:] != tuple(store.shape[1:]):
            raise ValueError(
                "row push shape mismatch for %r: %d ids, values %s vs "
                "stored rows of %s"
                % (key, ids.shape[0], vals.shape, tuple(store.shape[1:])))
        if ids.size and (ids.min() < 0 or ids.max() >= store.shape[0]):
            raise ValueError(
                "row push out of range for %r: ids [%d, %d] vs %d "
                "stored rows" % (key, int(ids.min()), int(ids.max()),
                                 store.shape[0]))
        ids_t = self._tensor(ids)
        vals_t = self._tensor(vals, store.dtype)
        if self._updater is None:
            vals_t, ids_t = sparse._canonicalize(vals_t, ids_t)
            if ids_t.numel():
                store.index_copy_(0, ids_t,
                                  store.index_select(0, ids_t) + vals_t)
            return
        w = NDArray(store, self._ctx)
        grad = sparse.RowSparseNDArray(NDArray(vals_t, self._ctx),
                                       NDArray(ids_t, self._ctx), w.shape,
                                       ctx=self._ctx)
        self._updater(key, grad, w)

    #: per-client window of claimed seqnos
    _SEEN_WINDOW = 128

    def _claim_push(self, meta):
        """Atomically claim this (client, seqno) push; False: already
        claimed (a retry after a lost reply, acked without applying). A
        set of recent seqnos, not a high-water mark: a failed send's retry
        may arrive after a higher seqno landed."""
        if not meta:
            return True
        cid, seq = meta["cid"], meta["seq"]
        with self._seen_lock:
            entry = self._seen.get(cid)
            if entry is None:
                entry = self._seen[cid] = (set(), deque())
            claimed, order = entry
            if seq in claimed:
                return False
            claimed.add(seq)
            order.append(seq)
            while len(order) > self._SEEN_WINDOW:
                claimed.discard(order.popleft())
            while len(self._seen) > 4096:  # dead clients age out
                self._seen.pop(next(iter(self._seen)))
            return True

    def _release_push(self, meta):
        """Undo the claim of a push whose apply failed."""
        if not meta:
            return
        with self._seen_lock:
            entry = self._seen.get(meta["cid"])
            if entry is not None:
                entry[0].discard(meta["seq"])

    def _pull_wire(self, key):
        """The current weights as a wire entry, copied to the host under
        the lock (the copy makes the zero-copy send safe outside it)."""
        with self._lock:
            if key not in self._store:
                raise KeyError("pull before init: %r" % (key,))
            snap = _host(self._store[key])
        return _arr_to_wire(snap, zero_copy=True)

    def _row_pull_wire(self, key, meta):
        """The asked rows of a stored table as one wire entry: only they
        leave the device."""
        if not isinstance(meta, dict) or "ids" not in meta:
            raise ValueError("row_pull requires meta={'ids': wire}")
        ids = np.asarray(_arr_from_wire(meta["ids"]), np.int64)
        with self._lock:
            if key not in self._store:
                raise KeyError("row_pull before init: %r" % (key,))
            store = self._store[key]
            if ids.size and (ids.min() < 0
                             or ids.max() >= store.shape[0]):
                raise ValueError(
                    "row_pull out of range for %r: ids [%d, %d] vs %d "
                    "stored rows" % (key, int(ids.min()),
                                     int(ids.max()), store.shape[0]))
            snap = _host(store.index_select(0, self._tensor(ids)))
        return _arr_to_wire(snap, zero_copy=True)

    def memory_bytes(self):
        """Bytes this server holds: stored values and optimizer states,
        the embedding sub-tables' (``@embshard`` keys) apart."""
        def _state_bytes(v):
            if isinstance(v, NDArray):
                return _nbytes(v.tensor)
            if isinstance(v, np.ndarray):
                return v.nbytes
            if isinstance(v, (list, tuple)):
                return sum(_state_bytes(i) for i in v)
            return 0

        with self._lock:
            out = {"keys": len(self._store), "store_bytes": 0,
                   "opt_bytes": 0, "embed_store_bytes": 0,
                   "embed_opt_bytes": 0}
            for k, v in self._store.items():
                out["store_bytes"] += _nbytes(v)
                if embedding_shard_rank(k) is not None:
                    out["embed_store_bytes"] += _nbytes(v)
            states = self._updater.states if self._updater is not None \
                else {}
            for k, v in states.items():
                b = int(_state_bytes(v))
                out["opt_bytes"] += b
                if embedding_shard_rank(k) is not None:
                    out["embed_opt_bytes"] += b
        return out

    def stored_devices(self):
        """The device of each stored value, by key."""
        with self._lock:
            return {k: v.device for k, v in self._store.items()}

    def _set_optimizer(self, name, meta):
        from . import optimizer

        # meta is {"kwargs": ..., "extras": ...}; a bare kwargs dict is
        # accepted as is
        meta = meta or {}
        if "kwargs" in meta or "extras" in meta:
            kwargs = meta.get("kwargs") or {}
            extras = meta.get("extras") or {}
        else:
            kwargs, extras = meta, {}
        with self._lock:
            if self._opt_config is not None:
                # first writer wins (every worker sends it); a different
                # config, the learning rate aside, is a misconfiguration
                def _sans_lr(cfg):
                    n, kw, ex = cfg
                    return (n, {k: v for k, v in kw.items()
                                if k != "learning_rate"}, ex)

                if _sans_lr(self._opt_config) != _sans_lr(
                        (name, kwargs, extras)):
                    raise ValueError(
                        "conflicting server optimizer: have %r, got %r"
                        % (self._opt_config, (name, kwargs, extras)))
                return
            opt = optimizer.create(name, **kwargs)
            self._apply_opt_extras(opt, extras)
            self._updater = optimizer.get_updater(opt)
            self._opt_config = (name, kwargs, extras)

    @staticmethod
    def _apply_opt_extras(opt, extras):
        """Install the per-parameter multipliers, the index->name map and
        a stock lr scheduler sent as plain data."""
        if extras.get("idx2name"):
            opt.idx2name = dict(extras["idx2name"])
        if extras.get("lr_mult"):
            # the client already normalized them: assign, do not re-run
            opt.lr_mult = dict(extras["lr_mult"])
        if extras.get("wd_mult"):
            opt.wd_mult = dict(extras["wd_mult"])
        sched = extras.get("lr_scheduler")
        if sched:
            from . import lr_scheduler as lr_mod

            cls_name, skw = sched
            klass = getattr(lr_mod, cls_name, None)
            if klass is None or not (isinstance(klass, type)
                                     and issubclass(klass,
                                                    lr_mod.LRScheduler)):
                raise ValueError(
                    "set_optimizer: unknown lr_scheduler class %r"
                    % (cls_name,))
            opt.lr_scheduler = klass(**dict(skw))

    def _barrier_state(self, name):
        b = self._barriers.setdefault(name, {"count": 0, "gen": 0})
        b["ts"] = time.monotonic()
        prune_barrier_names(self._barriers, self._barrier_errors, name,
                            quiescent=lambda s: s["count"] == 0)
        return b

    def _abort_barrier_locked(self, name, msg):
        """Fail the in-flight round: every waiter raises."""
        b = self._barrier_state(name)
        if b["count"] == 0:
            return
        self._barrier_errors[(name, b["gen"])] = msg
        while len(self._barrier_errors) > 8:
            self._barrier_errors.pop(next(iter(self._barrier_errors)))
        b["gen"] += 1
        b["count"] = 0
        self._barrier_cond.notify_all()

    @staticmethod
    def _conn_closed(conn):
        """Non-consuming liveness probe of a waiter's own socket."""
        try:
            return conn.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True

    def _barrier(self, conn=None, name=""):
        """Wait for every worker at ``name``. A waiter whose own worker
        disconnects aborts the round for every survivor (in elastic mode it
        retracts its arrival instead, so the respawn arrives again); a
        worker that never arrives is bounded by the timeout. Both reset
        the count."""
        with self._barrier_cond:
            b = self._barrier_state(name)
            gen = b["gen"]
            b["count"] += 1
            if b["count"] >= self._num_workers:
                b["count"] = 0
                b["gen"] += 1
                self._barrier_cond.notify_all()
                return
            deadline = time.monotonic() + self._barrier_timeout
            while b["gen"] == gen and not self._stop.is_set():
                if time.monotonic() >= deadline:
                    msg = ("barrier %stimed out after %.0fs (%d of %d "
                           "workers arrived)"
                           % ("%r " % name if name else "",
                              self._barrier_timeout, b["count"],
                              self._num_workers))
                    self._abort_barrier_locked(name, msg)
                    raise MXNetError(msg)
                if conn is not None and self._conn_closed(conn):
                    if self._elastic:
                        # the survivors keep waiting (bounded by the
                        # timeout) for the respawn to arrive
                        b["count"] = max(0, b["count"] - 1)
                        self._barrier_cond.notify_all()
                        raise ConnectionError(
                            "peer closed during barrier "
                            "(elastic: arrival retracted)")
                    self._abort_barrier_locked(
                        name, "barrier aborted: a waiting worker "
                        "disconnected")
                    raise ConnectionError("peer closed during barrier")
                self._barrier_cond.wait(timeout=0.2)
            err = self._barrier_errors.get((name, gen))
            if err is not None:
                raise MXNetError(err)
            if self._stop.is_set() and b["gen"] == gen:
                raise MXNetError("barrier aborted: server stopped")

    def _dispatch(self, op, key, meta, wire, conn=None):
        """One op -> its reply payload. Raises on a bad request; _handle
        turns that into an ``('err', text)`` reply."""
        if op == "init":
            with self._lock:
                if key not in self._store:
                    self._store[key] = self._tensor(_arr_from_wire(wire))
            return None
        if op == "push":
            if not self._claim_push(meta):
                return None  # a retried push: already claimed, ack only
            try:
                self._apply_push(key, _grad_from_wire(wire))
            except Exception:
                self._release_push(meta)
                raise
            return None
        if op == "push_multi":
            # a coalesced frame; each entry keeps its own (cid, seq)
            for k, m, w in wire:
                if not self._claim_push(m):
                    continue
                try:
                    self._apply_push(k, _grad_from_wire(w))
                except Exception:
                    self._release_push(m)
                    raise
            return None
        if op == "pull":
            return self._pull_wire(key)
        if op == "pull_multi":
            if not isinstance(key, (list, tuple)):
                raise ValueError("pull_multi expects a key list")
            return [self._pull_wire(k) for k in key]
        if op == "row_pull":
            return self._row_pull_wire(key, meta)
        if op == "mem":
            return self.memory_bytes()
        if op == "set_optimizer":
            self._set_optimizer(key, meta)
            return None
        if op == "opt_config":
            with self._lock:
                return self._opt_config
        if op == "num_workers":
            return self._num_workers
        if op == "barrier":
            self._barrier(conn, name=str(key or ""))
            return None
        if op == "rollback":
            return self._rollback(meta)
        if op == "save_opt":
            with self._lock:
                if self._updater is None:
                    raise ValueError("no server optimizer installed")
                return [(k, _state_to_wire(v)) for k, v in
                        self._updater.get_states_map().items()]
        if op == "load_opt":
            with self._lock:
                if self._updater is None:
                    raise ValueError("no server optimizer installed")
                if not isinstance(wire, (list, tuple)):
                    raise ValueError(
                        "load_opt expects [(key, state-wire)] pairs, got "
                        "%s (raw optimizer blobs are not accepted: the "
                        "server never unpickles network bytes)"
                        % type(wire).__name__)
                states = {k: _state_from_wire(w) for k, w in wire}
                self._updater.set_states_from_map(states)
            return None
        raise ValueError("unknown op %r" % (op,))

    def _handle(self, conn):
        try:
            while not self._stop.is_set():
                op, key, meta, wire = _recv_msg(conn)
                if chaos.rpc_fault(_chaos_op(op), side="server"):
                    # an injected server-side drop: the op is not applied
                    # and the connection resets under the client
                    raise ConnectionError("chaos: server dropped %r" % op)
                if op == "stop":
                    _send_msg(conn, ("ok", None))
                    self.shutdown()
                    return
                try:
                    payload = self._dispatch(op, key, meta, wire, conn=conn)
                except (ConnectionError, OSError):
                    raise  # this connection's peer vanished: no reply
                except Exception as e:  # a bad request: reply, go on
                    _send_msg(conn, ("err", "%s: %s"
                                     % (type(e).__name__, e)))
                    continue
                _send_msg(conn, ("ok", payload))
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(conn)
            conn.close()

    def serve_forever(self):
        """Accept loop; returns after a client sends ``stop`` or
        ``shutdown`` runs."""
        self._sock.settimeout(0.5)
        threads = []
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=2)

    def serve_in_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def restore_from_checkpoint(self, ckpt, shard_rank=0, num_shards=1):
        """Preload this server's key shard from a committed checkpoint: the
        ``arg:`` weights whose key routes here (crc32, the clients'
        routing; an embedding sub-key ``<key>@embshard<s>`` to server
        ``s % num_shards``; under ``MXNET_TPU_ZERO_SERVER=1`` a split key's
        slice ``shard_rank`` of the whole array), the optimizer rebuilt
        from the recorded config and its states of those keys (a split
        key's sliced alike). A respawned server runs it before it serves,
        so a retried push never meets an empty store. Returns the number
        of keys restored."""
        from .checkpoint import loads_plain, unwrap_states_map

        zero = (config.get_strict_bool("MXNET_TPU_ZERO_SERVER")
                and num_shards > 1)
        zero_min = config.get_nonneg_int("MXNET_TPU_ZERO_MIN_SIZE")
        zsizes = {}     # split key -> its slice table

        def mine(key):
            esr = embedding_shard_rank(key)
            if esr is not None:
                return esr % num_shards == shard_rank
            return shard_key(key, num_shards) == shard_rank

        restored = 0
        with self._lock:
            for name, arr in ckpt.weights().items():
                if not name.startswith("arg:"):
                    continue  # aux state never lives on a server
                key = name[len("arg:"):]
                arr = np.asarray(arr)
                if embedding_shard_rank(key) is None and zero and \
                        zero_value_sharded(arr, num_shards, zero_min):
                    zsizes[key] = zero_slice_sizes(arr.size, num_shards)
                    self._store[key] = self._tensor(zero_slice_pytree(
                        arr, zsizes[key], shard_rank))
                    restored += 1
                elif mine(key):
                    self._store[key] = self._tensor(arr)
                    restored += 1
        opt_cfg = ckpt.optimizer_config()
        if opt_cfg is not None:
            name, kwargs, extras = opt_cfg
            self._set_optimizer(name, {"kwargs": kwargs, "extras": extras})
        blob = ckpt.optimizer_states()
        if blob is not None and self._updater is not None:
            states = unwrap_states_map(loads_plain(blob, "optimizer states"))
            part = {k: zero_slice_pytree(v, zsizes[k], shard_rank)
                    for k, v in states.items() if k in zsizes}
            part.update((k, v) for k, v in states.items()
                        if k not in zsizes and mine(k))
            with self._lock:
                self._updater.set_states_from_map(part)
        return restored

    def _rollback(self, meta):
        """The health guard's coordinated rollback: reload this server's
        shard from the newest checkpoint of its own
        ``MXNET_CHECKPOINT_DIR`` (the op carries no path: wire input never
        chooses which local file is read) and scale the optimizer's lr by
        ``meta["lr_scale"]``. The restore is idempotent; the backoff is
        applied once a generation (``meta["gen"]``), so a retried op
        restores again without squaring it."""
        from .checkpoint import CheckpointManager

        meta = meta or {}
        ckpt_dir = config.get("MXNET_CHECKPOINT_DIR")
        if not ckpt_dir:
            raise ValueError(
                "rollback: this server has no MXNET_CHECKPOINT_DIR — "
                "nothing committed to roll back to")
        ck = CheckpointManager(ckpt_dir).latest()
        if ck is None:
            raise ValueError("rollback: no committed checkpoint under %s"
                             % ckpt_dir)
        shard_rank = _env_count("DMLC_SERVER_ID")
        num_shards = max(_env_count("DMLC_NUM_SERVER"), 1)
        nkeys = self.restore_from_checkpoint(ck, shard_rank=shard_rank,
                                             num_shards=num_shards)
        scale, gen, new_lr = meta.get("lr_scale"), meta.get("gen"), None
        if scale is not None:
            scale = float(scale)
            if not 0.0 < scale <= 1.0:
                raise ValueError("rollback: lr_scale=%r must be in "
                                 "(0, 1]" % (scale,))
            with self._lock:
                if gen is not None:
                    if int(gen) <= self._rollback_gen:
                        scale = None  # a retried generation: applied once
                    else:
                        self._rollback_gen = int(gen)
                if scale is not None and self._updater is not None:
                    opt = self._updater.optimizer
                    try:
                        opt.set_learning_rate(opt.lr * scale)
                        new_lr = opt.lr
                    except MXNetError as e:  # a scheduler-driven lr
                        print("[lifecycle] rollback lr backoff skipped: "
                              "%s" % e, flush=True)
                    if new_lr is not None and self._opt_config is not None:
                        # later checkpoints and respawned servers rebuild
                        # with the backed-off rate
                        n, kw, ex = self._opt_config
                        self._opt_config = (n, dict(kw, learning_rate=new_lr),
                                            ex)
        print("[lifecycle] event=rollback role=server rank=%d ckpt=%s "
              "keys=%d epoch=%d lr=%s"
              % (shard_rank, ck.path, nkeys, ck.epoch, new_lr), flush=True)
        return {"keys": int(nkeys), "epoch": int(ck.epoch), "lr": new_lr}

    def shutdown(self):
        self._stop.set()
        with self._barrier_cond:
            self._barrier_cond.notify_all()
        # unblock handler threads parked in recv
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class _PushFuture:
    """Completion handle of one queued push; ``wait()`` re-raises its
    failure."""

    __slots__ = ("_done", "error")

    def __init__(self):
        self._done = threading.Event()
        self.error = None

    def _finish(self, error=None):
        self.error = error
        self._done.set()

    def done(self):
        return self._done.is_set()

    def wait(self):
        self._done.wait()
        if self.error is not None:
            raise self.error


class _ShardSender:
    """One server's sender thread: pushes queue by priority (higher first,
    ties in order) and leave in coalesced ``push_multi`` frames of at most
    ``max_keys`` keys and ``max_bytes`` bytes. One sender a server keeps
    the server's seqno stream in send order."""

    def __init__(self, store, idx, max_keys=16, max_bytes=1 << 20,
                 start=True):
        self._store = store
        self._idx = idx
        self._max_keys = max(1, int(max_keys))
        self._max_bytes = max(1, int(max_bytes))
        self._cond = threading.Condition()
        self._heap = []         # (-priority, ticket, entry)
        self._ticket = 0
        self._inflight = 0      # queued + being sent
        self._stopped = False
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="kvstore-send-%d" % idx)
            self._thread.start()

    def enqueue(self, entry, priority=0):
        with self._cond:
            if self._stopped:
                raise MXNetError(
                    "kvstore sender for shard %d is stopped" % self._idx)
            heapq.heappush(self._heap,
                           (-int(priority), self._ticket, entry))
            self._ticket += 1
            self._inflight += 1
            depth = self._inflight
            self._cond.notify()
        profiler.comm_record("push", inflight=depth)

    def _next_batch_locked(self):
        batch = [heapq.heappop(self._heap)[2]]
        nbytes = batch[0]["nbytes"]
        while (self._heap and len(batch) < self._max_keys
               and nbytes < self._max_bytes):
            entry = heapq.heappop(self._heap)[2]
            batch.append(entry)
            nbytes += entry["nbytes"]
        return batch

    def _run(self):
        while True:
            with self._cond:
                while not self._heap and not self._stopped:
                    self._cond.wait()
                if not self._heap:
                    return  # stopped and drained
                batch = self._next_batch_locked()
            err = None
            try:
                self._store._send_push_batch(self._idx, batch)
            except BaseException as e:
                err = e
            for entry in batch:
                entry["future"]._finish(err)
            if err is not None:
                self._store._note_async_error(err)
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()

    def drain(self):
        """Block until nothing is queued or in flight."""
        with self._cond:
            while self._inflight:
                self._cond.wait()

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class ServerKVStore(kvstore.KVStore):
    """The client of one or more :class:`KVStoreServer` (the dist_async
    tier). The optimizer runs on the servers (``set_optimizer``): ``push``
    sends raw gradients, ``pull`` returns the updated weights. A subclass
    of :class:`kvstore.KVStore`, so an instance can be handed to
    ``Module.fit``; ``server_side`` tells ``Module`` to update through it
    and never through the fused step."""

    server_side = True

    #: ops retried over a new connection after a transport failure: reads,
    #: idempotent writes, pushes (deduped by their (cid, seq)) and rollback
    #: (its lr backoff deduped by generation); barrier and stop are not (a
    #: second arrival would count twice)
    _RETRY_SAFE = frozenset((
        "init", "push", "push_multi", "pull", "pull_multi", "num_workers",
        "save_opt", "load_opt", "set_optimizer", "opt_config",
        "row_pull", "mem", "rollback"))

    def __init__(self, uri, kv_type="dist_async", tracker_client=None,
                 pipeline=None):
        super().__init__(kv_type)
        if isinstance(uri, str):
            uris = [u for u in uri.split(",") if u]
        else:
            uris = list(uri)
        if not uris:
            raise MXNetError("ServerKVStore: no server URIs")
        self._uris = uris
        self._socks = [connect_with_backoff(u, deadline=30.0) for u in uris]
        self._wlocks = [threading.Lock() for _ in uris]
        self._tracker = tracker_client
        self._num_workers_cache = None
        # a fresh id a client: its pushes' dedupe identity
        self._client_id = uuid.uuid4().hex
        self._push_seq = [0] * len(uris)
        self._rpc_retries = env_nonneg_int("MXNET_KVSTORE_RPC_RETRIES")
        self._reconnect_deadline = env_positive_float(
            "MXNET_KVSTORE_RECONNECT_DEADLINE")
        self._rediscover_timeout = env_positive_float(
            "MXNET_KVSTORE_REDISCOVER_TIMEOUT")
        if pipeline is None:
            pipeline = config.get_choice("MXNET_KVSTORE_PIPELINE",
                                         ("0", "1")) == "1"
        self._pipeline = bool(pipeline)
        self._coalesce_keys = env_nonneg_int(
            "MXNET_KVSTORE_COALESCE_KEYS") or 1
        self._coalesce_bytes = env_nonneg_int(
            "MXNET_KVSTORE_COALESCE_BYTES") or 1
        self._senders = {}            # server index -> _ShardSender
        self._senders_lock = threading.Lock()
        self._key_pending = {}        # key -> [_PushFuture, ...]
        self._pending_lock = threading.Lock()
        self._async_error = None
        self._async_error_surfaced = False
        self._compression_params = None
        self._residuals = {}          # key (or (key, server)) -> residual
        self._closed = False
        # ZeRO value sharding: read from the knobs only, as every client
        # and a restoring server must split alike
        self._zero = (config.get_strict_bool("MXNET_TPU_ZERO_SERVER")
                      and len(uris) > 1)
        self._zero_min = config.get_nonneg_int("MXNET_TPU_ZERO_MIN_SIZE")
        self._zinfo = {}   # split key -> (shape, dtype str, slice sizes)

    @property
    def num_workers(self):
        env = os.environ.get("MXNET_TPU_NUM_WORKERS",
                             os.environ.get("DMLC_NUM_WORKER"))
        if env is not None:
            return int(env)
        if self._num_workers_cache is None:
            # no DMLC env: the server knows the count it gates barriers on
            self._num_workers_cache = int(self._rpc_idx(0, "num_workers"))
        return self._num_workers_cache

    @property
    def rank(self):
        if self._tracker is not None:
            return self._tracker.rank  # the scheduler's assignment
        return int(os.environ.get("MXNET_TPU_WORKER_ID",
                                  os.environ.get("DMLC_RANK",
                                                 os.environ.get(
                                                     "DMLC_WORKER_ID",
                                                     "0"))))

    def num_dead_node(self, node_id=0, timeout=60):
        """Dead peers by the scheduler's heartbeats; 0 without a
        tracker."""
        del node_id, timeout
        if self._tracker is None:
            return 0
        return self._tracker.num_dead_node()

    @property
    def num_servers(self):
        return len(self._socks)

    def _shard(self, key):
        return shard_key(key, len(self._socks))

    def _rpc_once(self, idx, op, key, meta, wire, timeout):
        """One request and its reply over the server's connection. A
        transport failure closes the connection (a late reply would be
        read as the next op's) and raises _RPCTransportError; an
        ``('err', ...)`` reply raises MXNetError. An ``rpc:drop`` rule
        drops the connection before the send or before the reply is
        read."""
        sock = None
        cop = _chaos_op(op)
        t0 = time.perf_counter()
        try:
            with self._wlocks[idx]:
                if op == "push" and meta is not None and "seq" not in meta:
                    # drawn under the send lock, on the first attempt only
                    meta["seq"] = self._push_seq[idx]
                    self._push_seq[idx] += 1
                sock = self._socks[idx]
                if chaos.rpc_fault(cop, phase="send"):
                    raise ConnectionResetError(
                        "chaos: dropped %r before send" % op)
                sock.settimeout(timeout)
                sent = _send_msg(sock, (op, key, meta, wire))
                if chaos.rpc_fault(cop, phase="reply"):
                    raise ConnectionResetError(
                        "chaos: dropped %r reply" % op)
                (status, payload), rcvd = _recv_msg(sock, with_size=True)
        except (socket.timeout, OSError, ConnectionError) as e:
            # close the captured socket: a reconnect may have replaced it
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            raise _RPCTransportError("%s: %s" % (type(e).__name__, e))
        profiler.comm_record(cop, wire_bytes=sent + rcvd,
                             seconds=time.perf_counter() - t0, count=1)
        if status != "ok":
            raise MXNetError("kvstore_server: %s" % (payload,))
        return payload

    def _reconnect(self, idx):
        """A new connection to server ``idx``. When its address is gone and
        a tracker is attached, the server list is fetched again: a
        respawned server registered its new port with the scheduler, and
        ``get_server_uris`` waits until every server is alive."""
        with self._wlocks[idx]:
            try:
                self._socks[idx].close()
            except OSError:
                pass
            try:
                self._socks[idx] = connect_with_backoff(
                    self._uris[idx], deadline=self._reconnect_deadline)
                return
            except TrackerError as e:
                if self._tracker is None:
                    raise _RPCTransportError(str(e))
            try:
                uris = self._tracker.get_server_uris(
                    timeout=self._rediscover_timeout)
            except TrackerError as e:
                raise _RPCTransportError("rediscovery failed: %s" % e)
            if len(uris) != len(self._uris):
                raise _RPCTransportError(
                    "rediscovery returned %d servers, expected %d"
                    % (len(uris), len(self._uris)))
            self._uris = list(uris)
            try:
                self._socks[idx] = connect_with_backoff(
                    self._uris[idx], deadline=self._reconnect_deadline)
            except TrackerError as e:
                raise _RPCTransportError(str(e))

    def _rpc_idx(self, idx, op, key=None, meta=None, wire=None,
                 timeout=60.0):
        """An RPC with bounded retry: a transport failure of a retry-safe
        op reconnects and sends the same request again (the same push
        seqno, so the server dedupes an applied one)."""
        retries = self._rpc_retries if op in self._RETRY_SAFE else 0
        last = None
        for attempt in range(retries + 1):
            if attempt:
                try:
                    self._reconnect(idx)
                except _RPCTransportError as e:
                    last = e
                    continue
            try:
                return self._rpc_once(idx, op, key, meta, wire, timeout)
            except _RPCTransportError as e:
                last = e
        raise MXNetError(
            "kvstore_server rpc %r to shard %d (%s) failed after %d "
            "attempt(s): %s%s" % (
                op, idx, self._uris[idx], retries + 1, last,
                "" if retries else "; connection closed"))

    def _rpc(self, op, key=None, meta=None, wire=None):
        """Keyed data ops go to the key's server, the rest to server 0."""
        if op in ("init", "push", "pull") and key is not None:
            return self._rpc_idx(self._shard(key), op, key, meta, wire)
        return self._rpc_idx(0, op, key, meta, wire)

    def _rpc_all(self, op, key=None, meta=None, wire=None, timeout=60.0):
        """The op on every server, in rank order (the same on every
        worker, so sharded barriers cannot deadlock)."""
        return [self._rpc_idx(i, op, key, meta, wire, timeout=timeout)
                for i in range(len(self._socks))]

    @staticmethod
    def _np(value):
        return value.asnumpy() if hasattr(value, "asnumpy") \
            else np.asarray(value)

    def _merged(self, value):
        """A per-context list is summed before it crosses the wire."""
        if isinstance(value, (list, tuple)):
            arrs = [self._np(v) for v in value]
            return arrs[0] if len(arrs) == 1 else np.sum(arrs, axis=0)
        return self._np(value)

    def init(self, key, value):
        """Each key's value on its server; under ZeRO a split key's slice
        ``i`` on server ``i``."""
        for k, v in _iter_kv(key, value):
            arr = self._merged(v)
            if self._zero and zero_value_sharded(arr, len(self._socks),
                                                 self._zero_min):
                sizes = zero_slice_sizes(arr.size, len(self._socks))
                self._zinfo[k] = (tuple(arr.shape), str(arr.dtype), sizes)
                for idx in range(len(sizes)):
                    self._rpc_idx(idx, "init", k, None, _arr_to_wire(
                        zero_slice_pytree(arr, sizes, idx)))
                continue
            self._rpc("init", k, None, _arr_to_wire(arr))

    # -- the pipelined push/pull --------------------------------------------
    def _check_async_error(self):
        err = self._async_error
        if err is not None:
            self._async_error_surfaced = True
            raise MXNetError(
                "kvstore: an earlier asynchronous push failed: %s" % err)

    def _note_async_error(self, err):
        if self._async_error is None:
            self._async_error = err

    def _sender(self, idx):
        with self._senders_lock:
            if self._closed:
                raise MXNetError(
                    "kvstore is closed: its senders are stopped")
            sender = self._senders.get(idx)
            if sender is None:
                sender = self._senders[idx] = _ShardSender(
                    self, idx, max_keys=self._coalesce_keys,
                    max_bytes=self._coalesce_bytes)
            return sender

    def _send_push_batch(self, idx, batch):
        """On server ``idx``'s sender thread: seqnos in send order, then
        one RPC for the batch (``push_multi`` for more than one)."""
        for entry in batch:
            if "seq" not in entry["meta"]:
                entry["meta"]["seq"] = self._push_seq[idx]
                self._push_seq[idx] += 1
        if len(batch) == 1:
            entry = batch[0]
            self._rpc_idx(idx, "push", entry["key"], entry["meta"],
                          entry["wire"])
        else:
            self._rpc_idx(idx, "push_multi", None, None,
                          [(e["key"], e["meta"], e["wire"])
                           for e in batch])

    def _wait_key(self, k):
        """Block on this key's queued pushes only."""
        with self._pending_lock:
            futs = self._key_pending.pop(k, ())
        for f in futs:
            try:
                f.wait()
            except BaseException:
                self._async_error_surfaced = True
                raise

    def wait_outstanding(self):
        """Block until every queued push is acked (or failed its retries),
        then raise the first failure."""
        with self._senders_lock:
            senders = [self._senders[i] for i in sorted(self._senders)]
        for sender in senders:
            sender.drain()
        with self._pending_lock:
            pending, self._key_pending = self._key_pending, {}
        for futs in pending.values():
            for f in futs:
                try:
                    f.wait()
                except BaseException:
                    self._async_error_surfaced = True
                    raise
        self._check_async_error()

    def push(self, key, value, priority=0):
        """Queue each key's summed gradient on its server's sender and
        return. With compression set, a dense float gradient crosses as
        packed 2-bit codes (a row-sparse value is sent dense and raw, as
        in the JAX package)."""
        from .ndarray.sparse import RowSparseNDArray

        self._check_async_error()
        for k, v in _iter_kv(key, value):
            v0 = v[0] if isinstance(v, (list, tuple)) and len(v) else v
            arr = self._merged(v)
            is_rsp = isinstance(v0, RowSparseNDArray)
            profiler.comm_record("push", raw_bytes=int(arr.nbytes))
            zinfo = None if is_rsp else self._zinfo.get(k)
            if zinfo is not None:
                # a split key scatters: slice i to server i, each slice
                # with its own residual
                flat = np.asarray(arr)
                for idx in range(len(zinfo[2])):
                    sl = zero_slice_pytree(flat, zinfo[2], idx)
                    self._push_shard(idx, k, sl,
                                     self._compress((k, idx), sl), priority)
                continue
            self._push_shard(self._shard(k), k, arr,
                             None if is_rsp else self._compress(k, arr),
                             priority)

    def _compress(self, rkey, arr):
        """``(packed, threshold)`` of a dense float gradient under 2-bit
        compression (the residual kept under ``rkey``), else None."""
        if self._compression_params is None or \
                not np.issubdtype(arr.dtype, np.floating):
            return None
        threshold = self._compression_params["threshold"]
        packed, self._residuals[rkey] = two_bit_quantize(
            arr, self._residuals.get(rkey), threshold)
        return packed, threshold

    def _push_shard(self, idx, k, arr, compressed, priority):
        if not self._pipeline:
            self._rpc_idx(idx, "push", k, {"cid": self._client_id},
                          _grad_to_wire(arr, compressed))
            return
        if compressed is None and arr.flags.writeable:
            # the caller may reuse its buffer before the sender ships it
            arr = np.array(arr, copy=True)
        self._enqueue(idx, k, _grad_to_wire(arr, compressed),
                      int(compressed[0].nbytes if compressed
                          else arr.nbytes), priority)

    def _enqueue(self, idx, k, wire, nbytes, priority):
        entry = {"key": k, "meta": {"cid": self._client_id},
                 "wire": wire, "nbytes": nbytes, "future": _PushFuture()}
        with self._pending_lock:
            self._key_pending.setdefault(k, []).append(entry["future"])
        try:
            self._sender(idx).enqueue(entry, priority)
        except BaseException as e:
            # a future never queued still completes: no wait hangs on it
            entry["future"]._finish(e)
            raise

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("kvstore.pull requires out=")
        self._check_async_error()
        pairs = list(_iter_kv(key, out))
        for k, _o in pairs:
            self._wait_key(k)
        # one pull_multi frame a server; a ZeRO-split key from every one
        reqs = [[] for _ in self._socks]
        seen = set()
        for k, _o in pairs:
            if k not in seen:
                seen.add(k)
                for idx in self._holders(k):
                    reqs[idx].append(k)
        fetched = {}
        for idx, ks in enumerate(reqs):
            if not ks:
                continue
            if len(ks) == 1:
                wires = [self._rpc_idx(idx, "pull", ks[0])]
            else:
                wires = self._rpc_idx(idx, "pull_multi", ks)
            for k, w in zip(ks, wires):
                fetched[(idx, k)] = _arr_from_wire(w)
        for k, o in pairs:
            arr = self._joined(k, [fetched[(i, k)]
                                   for i in self._holders(k)])
            targets = o if isinstance(o, (list, tuple)) else [o]
            for t in targets:
                t[:] = arr

    def _holders(self, k):
        """The servers holding key ``k`` (every one for a split key)."""
        if k in self._zinfo:
            return range(len(self._socks))
        return (self._shard(k),)

    def _joined(self, k, parts):
        """A key's whole value from its holders' arrays."""
        if k not in self._zinfo:
            return parts[0]
        return np.concatenate([p.reshape(-1) for p in parts]) \
            .reshape(self._zinfo[k][0])

    def _pull_full(self, k):
        """One key's whole value (a split key gathered)."""
        return self._joined(k, [_arr_from_wire(self._rpc_idx(i, "pull", k))
                                for i in self._holders(k)])

    # lr schedulers that cross as plain data: class -> (ctor arg, attr)
    _SCHED_WIRE = {
        "FactorScheduler": (("step", "step"), ("factor", "factor"),
                            ("stop_factor_lr", "stop_factor_lr"),
                            ("base_lr", "base_lr")),
        "MultiFactorScheduler": (("step", "step"), ("factor", "factor"),
                                 ("base_lr", "base_lr")),
        # PolyScheduler decays from its construction-time base_lr_orig
        "PolyScheduler": (("max_update", "max_update"), ("pwr", "power"),
                          ("base_lr", "base_lr_orig")),
        "LRScheduler": (("base_lr", "base_lr"),),
    }

    @classmethod
    def _opt_extras(cls, opt):
        """The optimizer config that crosses as plain data (lr_mult,
        wd_mult, idx2name, a stock lr scheduler); what cannot
        (param_dict, another scheduler class) is dropped with a
        warning."""
        extras, dropped = {}, []
        if opt.idx2name:
            extras["idx2name"] = dict(opt.idx2name)
        if opt.lr_mult:
            extras["lr_mult"] = dict(opt.lr_mult)
        if opt.wd_mult:
            extras["wd_mult"] = dict(opt.wd_mult)
        if opt.lr_scheduler is not None:
            spec = cls._SCHED_WIRE.get(type(opt.lr_scheduler).__name__)
            if spec is not None and type(opt.lr_scheduler).__module__ \
                    .endswith("lr_scheduler"):
                extras["lr_scheduler"] = (
                    type(opt.lr_scheduler).__name__,
                    {ctor: getattr(opt.lr_scheduler, attr)
                     for ctor, attr in spec})
            else:
                dropped.append("lr_scheduler (%s is not a stock "
                               "lr_scheduler class)"
                               % type(opt.lr_scheduler).__name__)
        if opt.param_dict:
            dropped.append("param_dict (live Parameter objects cannot "
                           "cross the data-only wire)")
        if dropped:
            warnings.warn(
                "ServerKVStore.set_optimizer: DROPPING %s — the "
                "server-side optimizer will run without it. Fold the "
                "equivalent config into lr_mult/wd_mult or a stock "
                "lr scheduler." % "; ".join(dropped), stacklevel=3)
        return extras

    def set_optimizer(self, optimizer_or_name, **kwargs):
        """Install the server-side optimizer on every server: a name and
        kwargs, or an Optimizer whose scalar hyperparameters (matched
        against its classes' ``__init__`` signatures) and extras
        travel."""
        extras = {}
        if isinstance(optimizer_or_name, str):
            name, kw = optimizer_or_name, kwargs
        else:
            import inspect

            opt = optimizer_or_name
            name = type(opt).__name__.lower()
            kw = dict(kwargs)
            for klass in type(opt).__mro__:
                if not hasattr(klass, "__init__"):
                    continue
                try:
                    params = inspect.signature(klass.__init__).parameters
                except (TypeError, ValueError):
                    continue
                for p in params:
                    attr = "lr" if p == "learning_rate" else p
                    if p in ("self", "args", "kwargs") \
                            or not hasattr(opt, attr):
                        continue
                    v = getattr(opt, attr)
                    if isinstance(v, (int, float, str, bool)):
                        kw.setdefault(p, v)
            extras = self._opt_extras(opt)
        self._rpc_all("set_optimizer", name,
                      {"kwargs": kw, "extras": extras})

    def set_updater(self, updater):
        """Refused: the updates run on the servers."""
        raise MXNetError(
            "ServerKVStore applies updates server-side: use "
            "set_optimizer(name, **kwargs), not a client updater")

    _set_updater = set_updater

    def set_gradient_compression(self, compression_params):
        """2-bit wire compression of dense float pushes, with an
        error-feedback residual a key."""
        self._compression_params = validate_compression_params(
            compression_params)
        self._residuals = {}

    def comm_stats(self, reset=False):
        """The process's comms counters (``profiler.comm_stats``)."""
        return profiler.comm_stats(reset=reset)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The servers' optimizer states, merged into one local file (the
        pickle of a ``{key: numpy state}`` map, as ``Updater.get_states``
        writes), written atomically (``checkpoint.atomic_write_bytes``)."""
        from .checkpoint import atomic_write_bytes

        self.wait_outstanding()
        per_server = [{k: _state_from_wire(w) for k, w in wire}
                      for wire in self._rpc_all("save_opt")]
        states_map, zparts = {}, {}
        for idx, smap in enumerate(per_server):
            for k, v in smap.items():
                if k in self._zinfo:
                    zparts.setdefault(k, {})[idx] = v
                else:
                    states_map[k] = v
        for k, parts in zparts.items():
            if len(parts) != len(per_server):
                warnings.warn(
                    "save_optimizer_states: value-sharded key %r has "
                    "state on %d of %d servers (no push reached the "
                    "others yet); skipping it" % (k, len(parts),
                                                  len(per_server)),
                    stacklevel=2)
                continue
            states_map[k] = self._zero_join_state(
                k, [parts[i] for i in range(len(per_server))])
        atomic_write_bytes(fname, pickle.dumps(states_map, protocol=4))

    def _zero_join_state(self, k, parts):
        """The servers' state slices of a split key as one state: array
        leaves joined in server order and reshaped to the key's shape,
        other leaves (the same on every server) from the first."""
        shape = self._zinfo[k][0]
        total = int(np.prod(shape))

        def join(*leaves):
            l0 = leaves[0]
            if isinstance(l0, np.ndarray):
                flat = np.concatenate([np.asarray(x).reshape(-1)
                                       for x in leaves])
                return flat.reshape(shape) if flat.size == total else flat
            if isinstance(l0, (list, tuple)):
                return type(l0)(join(*grp) for grp in zip(*leaves))
            return l0

        return join(*parts)

    def get_optimizer_config(self):
        """The server-side optimizer's ``(name, kwargs, extras)``, or None
        before ``set_optimizer``."""
        return self._rpc_idx(0, "opt_config")

    def load_optimizer_states(self, fname):
        """A local states file to the servers' optimizers (read here with
        the restricted unpickler; the wire carries plain data)."""
        from .optimizer import loads_states

        self.wait_outstanding()
        with open(fname, "rb") as f:
            states_map = loads_states(f.read())
        by_server = [[] for _ in self._socks]
        for k, v in states_map.items():
            if k in self._zinfo:
                # a whole state split for the servers this client has
                sizes = self._zinfo[k][2]
                for idx in range(len(sizes)):
                    by_server[idx].append((k, _state_to_wire(
                        zero_slice_pytree(v, sizes, idx))))
            else:
                by_server[self._shard(k)].append((k, _state_to_wire(v)))
        for idx, pairs in enumerate(by_server):
            self._rpc_idx(idx, "load_opt", wire=pairs)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The asked rows (unique and sorted) of each key's full value:
        into a ``RowSparseNDArray`` out, or scattered into zeros of a
        dense out."""
        from .ndarray.ndarray import array
        from .ndarray.sparse import RowSparseNDArray

        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        self._check_async_error()
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        for k, o in _iter_kv(key, out):
            self._wait_key(k)
            w = self._pull_full(k)
            targets = o if isinstance(o, (list, tuple)) else [o]
            key_rids = list(rids) * len(targets) \
                if len(rids) == 1 and len(targets) > 1 else list(rids)
            for t, rid in zip(targets, key_rids):
                ids = np.unique(np.asarray(
                    rid.asnumpy() if hasattr(rid, "asnumpy") else rid,
                    np.int64))
                if ids.size and (ids[0] < 0 or ids[-1] >= w.shape[0]):
                    raise MXNetError(
                        "row_sparse_pull: row_ids out of range for key "
                        "%r: [%d, %d] vs %d rows"
                        % (k, int(ids[0]), int(ids[-1]), w.shape[0]))
                if isinstance(t, RowSparseNDArray):
                    t._rebind_sparse(RowSparseNDArray(
                        array(w[ids], ctx=t.context),
                        array(ids, ctx=t.context), w.shape,
                        ctx=t.context))
                else:
                    dense = np.zeros(w.shape, w.dtype)
                    dense[ids] = w[ids]
                    t[:] = dense

    # -- the embedding row data plane ---------------------------------------
    def row_pull(self, server_idx, key, ids):
        """Exactly the rows ``ids`` of the table ``key`` on server
        ``server_idx``, in request order, after this key's queued pushes
        (one ``row_pull`` RPC whose wire holds only those rows)."""
        self._check_async_error()
        self._wait_key(key)
        ids = np.ascontiguousarray(np.asarray(ids), dtype=np.int64)
        wire = self._rpc_idx(int(server_idx), "row_pull", key,
                             {"ids": _arr_to_wire(ids)})
        return _arr_from_wire(wire)

    def row_push(self, server_idx, key, ids, values, priority=0,
                 compressed=None):
        """Push a row-granular gradient ``(ids, values)`` of ``key`` on
        server ``server_idx`` through the same sender pipeline as dense
        pushes; ``compressed`` is an optional ``(packed, threshold)``
        pair of ``two_bit_quantize`` of ``values``."""
        self._check_async_error()
        ids = np.ascontiguousarray(np.asarray(ids), dtype=np.int64)
        values = np.asarray(values)
        if self._pipeline and compressed is None \
                and values.flags.writeable:
            values = np.array(values, copy=True)
        wire = _rows_to_wire(ids, values, compressed)
        nbytes = int(ids.nbytes) + int(
            compressed[0].nbytes if compressed else values.nbytes)
        profiler.comm_record("push", raw_bytes=int(ids.nbytes
                                                   + values.nbytes))
        if not self._pipeline:
            self._rpc_idx(int(server_idx), "push", key,
                          {"cid": self._client_id}, wire)
            return
        self._enqueue(int(server_idx), key, wire, nbytes, priority)

    def server_memory(self):
        """Each server's ``memory_bytes``, in rank order."""
        self.wait_outstanding()
        return self._rpc_all("mem")

    def barrier(self, name=""):
        """Barrier across the workers at every server, in rank order,
        after draining this client's pushes; the server raises when a
        peer dies or its timeout expires."""
        self.wait_outstanding()
        bt = env_positive_float("MXNET_KVSTORE_BARRIER_TIMEOUT")
        self._rpc_all("barrier", key=name or None, timeout=bt + 30.0)

    def reset_gradient_residuals(self):
        """Drop this client's 2-bit error-feedback residuals. Every rank
        calls it across a rollback (``HealthGuard`` does, in the quiesced
        window): the residuals refer to the weights before it, and a NaN
        one would quantize the rank's pushes to zero codes for good."""
        self.wait_outstanding()
        self._residuals = {}

    def rollback_servers(self, lr_scale=None, gen=None):
        """Every server reloads its shard (weights and optimizer state)
        from the newest checkpoint of its own ``MXNET_CHECKPOINT_DIR`` and
        scales its lr by ``lr_scale``, once a generation ``gen`` (the
        guard's rollback count). Call it in a quiesced barrier window, from
        rank 0. Returns ``{"keys": restored keys, all servers, "epoch",
        "lr": the new lr}``."""
        self.reset_gradient_residuals()
        meta = {}
        if lr_scale is not None:
            meta["lr_scale"] = float(lr_scale)
        if gen is not None:
            meta["gen"] = int(gen)
        infos = [i for i in self._rpc_all("rollback", meta=meta) if i]
        if not infos:
            raise MXNetError("rollback_servers: no server reported a "
                             "restore")
        return {"keys": sum(int(i.get("keys", 0)) for i in infos),
                "epoch": infos[0].get("epoch"),
                "lr": infos[0].get("lr")}

    def stop_server(self):
        self.wait_outstanding()
        self._rpc_all("stop")

    def close(self):
        surfaced = self._async_error_surfaced
        try:
            self.wait_outstanding()
        except Exception as e:
            # close does not raise, but a failure first seen here warns
            if not surfaced:
                warnings.warn(
                    "kvstore close(): undelivered async push failure: "
                    "%s" % e, stacklevel=2)
        with self._senders_lock:
            self._closed = True
            for sender in self._senders.values():
                sender.stop()
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass


def _iter_kv(key, value):
    """Pair keys with values: a single key takes the whole value (maybe a
    per-context list), a key list zips."""
    if isinstance(key, (list, tuple)):
        for k, v in zip(key, value):
            yield str(k), v
    else:
        yield str(key), value


# ---------------------------------------------------------------------------
# entry point (DMLC_ROLE dispatch)
# ---------------------------------------------------------------------------
def _init_kvstore_server_module():
    """``python -m mxnet_tpu_torch.kvstore_server``: the scheduler role runs
    the tracker (exit 0 without its environment), the server role serves
    under ``MXNET_KVSTORE_SERVER=1`` until stopped; any other role exits
    0."""
    import sys

    from . import tracker as trk

    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role not in ("server", "scheduler"):
        return
    if role == "scheduler":
        sys.exit(trk.main() if trk.tracker_env_spec() is not None else 0)
    if os.environ.get("MXNET_KVSTORE_SERVER") != "1":
        sys.exit(0)
    spec = trk.tracker_env_spec()
    # a scheduler on another host: bind the wildcard and advertise a
    # routable address (a loopback bind would strand remote workers)
    multi_host = spec is not None and \
        spec[0].rsplit(":", 1)[0] not in ("127.0.0.1", "localhost")
    host = os.environ.get("MXNET_PS_BIND_HOST",
                          "" if multi_host else "127.0.0.1")
    # under a scheduler DMLC_PS_ROOT_PORT is the scheduler's: never bind it
    default_port = "0" if spec is not None \
        else os.environ.get("DMLC_PS_ROOT_PORT", "0")
    port = int(os.environ.get("MXNET_PS_BIND_PORT", default_port) or 0)
    nw = int(os.environ.get("MXNET_TPU_NUM_WORKERS",
                            os.environ.get("DMLC_NUM_WORKER", "1")))
    # the store's device: the card unless the job asks for the CPU (a
    # variable of the launcher's environment, as DMLC_SERVER_ID is)
    device = os.environ.get("MXNET_PS_SERVER_DEVICE", "cuda")
    if device not in ("cuda", "cpu"):
        raise MXNetError("MXNET_PS_SERVER_DEVICE=%r must be cuda or cpu"
                         % device)
    server = KVStoreServer(host=host, port=port, num_workers=nw,
                           device=device)
    # restore BEFORE registering, whenever the directory holds a
    # checkpoint (a whole-job restart resets the restart count): workers
    # find the URI only once the store holds the restored state
    restart = _env_count("DMLC_RESTART_COUNT")
    ckpt_dir = os.environ.get("MXNET_CHECKPOINT_DIR")
    restored_from = None
    if ckpt_dir:
        from .checkpoint import CheckpointManager

        ck = CheckpointManager(ckpt_dir).latest()
        if ck is not None:
            shard_rank = _env_count("DMLC_SERVER_ID")
            num_shards = max(_env_count("DMLC_NUM_SERVER"), 1)
            nkeys = server.restore_from_checkpoint(
                ck, shard_rank=shard_rank, num_shards=num_shards)
            restored_from = ck.path
            print("[lifecycle] event=restored-from role=server rank=%d "
                  "ckpt=%s keys=%d epoch=%d"
                  % (shard_rank, ck.path, nkeys, ck.epoch), flush=True)
        elif restart > 0:
            print("kvstore_server: restart %d but no checkpoint in %s; "
                  "starting empty" % (restart, ckpt_dir), flush=True)
    client = None
    if spec is not None:
        advertise = os.environ.get("MXNET_PS_ADVERTISE_HOST")
        if advertise is None and multi_host:
            # the interface toward the scheduler (a UDP connect sends
            # nothing: it only picks the local endpoint)
            sched_host, sched_port = spec[0].rsplit(":", 1)
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.connect((sched_host, int(sched_port)))
                advertise = probe.getsockname()[0]
            finally:
                probe.close()
        bound_port = server.addr.rsplit(":", 1)[1]
        addr = "%s:%s" % (advertise, bound_port) if advertise \
            else server.addr
        # a respawn registers with its old rank and its restart count, so
        # the scheduler swaps the dead node's URI for this one
        server_rank = os.environ.get("DMLC_SERVER_ID")
        client = trk.TrackerClient(
            spec[0], "server", addr=addr,
            rank=int(server_rank) if server_rank is not None else None,
            restart_count=restart)
        if restored_from is not None:
            client.log_event("restored-from", role="server",
                             rank=server_rank or "0", ckpt=restored_from)
    print("kvstore_server listening on %s" % server.addr, flush=True)
    server.serve_forever()
    if client is not None:
        client.done()  # a graceful stop: 'done', not 'dead'
        client.close()
    sys.exit(0)


if __name__ == "__main__":
    _init_kvstore_server_module()
