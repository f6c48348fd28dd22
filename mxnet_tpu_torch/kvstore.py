"""KVStore — data-parallel parameter synchronization (counterpart of
``mxnet_tpu/kvstore.py``: ``create``, the in-process ``KVStore`` and the
``'tpu'`` tier ``TPUKVStore``).

``KVStore`` keeps the JAX package's surface and arithmetic: ``init`` stores
a copy of the first value, ``push`` sums a key's list of values (one a
context) and gives the sum to the updater, or adds it to the stored value
when there is none, ``pull`` copies the stored value out; ``set_optimizer``
runs the optimizer on the store; ``save``/``load_optimizer_states`` write
the updater's states. Its ``rank`` is 0 and ``num_workers`` 1.

``TPUKVStore`` (``'tpu'``) is the data-parallel tier. The JAX package runs
it in one process over a device mesh; the port runs one process a device,
so its ``rank``, ``num_workers`` and ``barrier`` come from the default
process group, ``init`` takes rank 0's value on every rank, and ``push``
sums over the ranks too: every rank's store then takes the same update,
and ``Module``'s per-executor update trains the same on every rank.
``Module`` attaches the fused step's mesh to it (``attach_mesh``).

``row_sparse_pull`` pulls the unique sorted rows asked for: into a
``RowSparseNDArray`` out, or scattered into zeros of a dense out (the rows
not asked for become 0, as in the JAX package). Row-sparse gradients pushed
from several contexts are summed sparsely (``sparse.add``).

``create("dist_async")`` with ``MXNET_PS_SERVER_URI`` set is the
parameter-server tier's client, ``kvstore_server.ServerKVStore``. The 2-bit
wire of that tier is here: ``validate_compression_params``,
``two_bit_quantize`` and ``two_bit_dequantize`` (numpy, the JAX package's
packing bit for bit).

Not ported, raising by name (ROADMAP.md Queue A item 10c): gradient
compression on the in-process stores (``set_gradient_compression``), the
other ``dist_*`` types, and ``dist_async`` from a tracker's rendezvous.
"""
from __future__ import annotations


import numpy as np
import torch

from . import config
from .base import MXNetError
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray

# ---------------------------------------------------------------------------
# 2-bit gradient compression: the wire format of the server tier
# ---------------------------------------------------------------------------
_COMPRESSION_KEYS = frozenset(("type", "threshold"))


def validate_compression_params(compression_params):
    """Validated copy of a ``set_gradient_compression`` params dict:
    unknown keys and a threshold that is not a finite float > 0 raise."""
    if not isinstance(compression_params, dict):
        raise MXNetError("set_gradient_compression expects a dict, got %r"
                         % type(compression_params).__name__)
    unknown = sorted(set(compression_params) - _COMPRESSION_KEYS)
    if unknown:
        raise MXNetError(
            "set_gradient_compression: unknown key(s) %s (supported: "
            "type, threshold)" % ", ".join(map(repr, unknown)))
    if compression_params.get("type") not in ("2bit",):
        raise MXNetError("unsupported compression type %r"
                         % compression_params.get("type"))
    threshold = compression_params.get("threshold", 0.5)
    if isinstance(threshold, bool) or not isinstance(
            threshold, (int, float, np.floating, np.integer)):
        raise MXNetError(
            "set_gradient_compression: threshold must be a finite float "
            "> 0, got %r" % (threshold,))
    threshold = float(threshold)
    if not 0.0 < threshold < float("inf"):  # also rejects NaN
        raise MXNetError(
            "set_gradient_compression: threshold must be a finite float "
            "> 0, got %r" % (threshold,))
    return {"type": "2bit", "threshold": threshold}


def two_bit_quantize(grad, residual, threshold):
    """Quantize ``grad + residual`` to 2-bit codes (+threshold -> 0b01,
    -threshold -> 0b10, else 0), 4 values a byte. Returns ``(packed uint8
    array of ceil(n/4) bytes, new residual)``: the residual carries the
    quantization error into the next round (error feedback)."""
    g = np.asarray(grad)
    res = np.zeros(g.shape, g.dtype) if residual is None \
        else np.asarray(residual, g.dtype)
    a = g + res
    t = g.dtype.type(threshold)
    pos = a >= t
    neg = a <= -t
    quant = np.where(pos, t, np.where(neg, -t, g.dtype.type(0)))
    codes = (pos.astype(np.uint8) | (neg.astype(np.uint8) << 1)).reshape(-1)
    pad = (-codes.size) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((pad,), np.uint8)])
    q4 = codes.reshape(-1, 4)
    packed = q4[:, 0] | (q4[:, 1] << 2) | (q4[:, 2] << 4) | (q4[:, 3] << 6)
    return packed.astype(np.uint8), (a - quant).astype(g.dtype)


def two_bit_dequantize(packed, shape, dtype, threshold):
    """Unpack 2-bit codes back to {-threshold, 0, +threshold}."""
    if isinstance(packed, (bytes, bytearray, memoryview)):
        packed = np.frombuffer(packed, np.uint8)
    else:
        packed = np.asarray(packed, np.uint8)
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    codes = np.empty((packed.size, 4), np.uint8)
    for j in range(4):
        codes[:, j] = (packed >> (2 * j)) & 3
    flat = codes.reshape(-1)[:n]
    t = np.dtype(dtype).type(threshold)
    out = np.zeros(n, dtype)
    out[flat == 1] = t
    out[flat == 2] = -t
    return out.reshape(shape)


def _key_list(key):
    if isinstance(key, (str, int)):
        return [key], True
    return list(key), False


def _val_list(value, nkeys):
    """Normalize to a list of lists: per key, the per-context values."""
    if isinstance(value, NDArray):
        return [[value]]
    if isinstance(value, (list, tuple)):
        if value and isinstance(value[0], NDArray):
            if nkeys == 1:
                return [list(value)]
            if len(value) == nkeys:
                return [[v] for v in value]
            raise MXNetError("kvstore: value count %d mismatches keys %d"
                             % (len(value), nkeys))
        return [list(v) for v in value]
    raise MXNetError("kvstore: bad value type %r" % type(value))


class KVStore:
    """In-process kvstore (the ``local`` and ``device`` types)."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._barrier_before_exit = True

    # -- init/push/pull ------------------------------------------------------
    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k in self._store:
                continue
            self._store[k] = self._sync_init(vlist[0].copy())

    def push(self, key, value, priority=0):
        """Sum each key's values (one a context), then give the sum to the
        updater, or add it to the stored value."""
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("kvstore: key %r not initialized" % (k,))
            agg = self._sum_workers(self._reduce(vlist))
            store = self._store[k]
            if agg.context != store.context:
                agg = agg.copyto(store.context)
            if self._updater is not None:
                self._updater(k, agg, store)
            else:
                store += agg

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, _ = _key_list(key)
        if out is None:
            raise MXNetError("kvstore.pull requires out=")
        outs = _val_list(out, len(keys))
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("kvstore: key %r not initialized" % (k,))
            for o in olist:
                self._store[k].copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (unique and sorted first; an id
        out of range raises): a ``RowSparseNDArray`` out receives them, a
        dense out receives them scattered into zeros."""
        from .ndarray.sparse import RowSparseNDArray

        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, _ = _key_list(key)
        outs = _val_list(out, len(keys))
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("kvstore: key %r not initialized" % (k,))
            src = self._store[k].tensor.detach()
            # per key: a single row-id array serves every out of this key
            key_rids = rids * len(olist) \
                if len(rids) == 1 and len(olist) > 1 else rids
            for o, rid in zip(olist, key_rids):
                rid_t = rid.tensor if isinstance(rid, NDArray) \
                    else torch.as_tensor(np.asarray(rid))
                ids = torch.unique(rid_t.to(src.device).long().reshape(-1))
                if ids.numel():
                    lo, hi = int(ids[0]), int(ids[-1])
                    if lo < 0 or hi >= src.shape[0]:
                        raise MXNetError(
                            "row_sparse_pull: row_ids out of range for key "
                            "%r: [%d, %d] vs %d rows"
                            % (k, lo, hi, src.shape[0]))
                taken = src.index_select(0, ids)
                dev = o.context.torch_device()
                if isinstance(o, RowSparseNDArray):
                    o._rebind_sparse(RowSparseNDArray(
                        NDArray(taken.to(dev), o.context),
                        NDArray(ids.to(dev), o.context), src.shape,
                        ctx=o.context))
                else:
                    dense = src.new_zeros(src.shape)
                    dense[ids] = taken
                    with torch.no_grad():
                        o.tensor.copy_(dense.reshape(o.shape))

    @staticmethod
    def _reduce(vlist):
        """The sum of one key's values, on the first value's device;
        row-sparse values are summed sparsely."""
        if len(vlist) == 1:
            return vlist[0]
        from .ndarray import sparse as nd_sparse

        if all(isinstance(v, nd_sparse.RowSparseNDArray) for v in vlist):
            total = vlist[0]
            for v in vlist[1:]:
                total = nd_sparse.add(total, v)
            return total
        total = vlist[0].tensor.detach().clone()
        for v in vlist[1:]:
            total += v.tensor.detach().to(total.device)
        return NDArray(total, vlist[0].context)

    def _sync_init(self, value):
        """The value every worker stores (the in-process store's own)."""
        return value

    def _sum_workers(self, agg):
        """The sum over the workers (the in-process store has one)."""
        return agg

    # -- optimizer/updater ---------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run the optimizer on the store: each push updates the stored
        value in place."""
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        validate_compression_params(compression_params)
        raise MXNetError("kvstore.set_gradient_compression: gradient "
                         "compression of the in-process stores is not "
                         "ported (ROADMAP.md Queue A item 10c; the server "
                         "tier's ServerKVStore compresses its wire)")

    # -- distributed surface -------------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        nd.waitall()

    def num_dead_node(self, node_id=0, timeout=60):
        """Dead workers: 0 for a store of live processes."""
        del node_id, timeout
        return 0

    def set_barrier_before_exit(self, barrier_before_exit=True):
        self._barrier_before_exit = bool(barrier_before_exit)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, written atomically
        (``checkpoint.atomic_write_bytes``)."""
        from .checkpoint import atomic_write_bytes

        if self._updater is None:
            raise MXNetError("kvstore: no updater to save")
        atomic_write_bytes(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("kvstore: no updater")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


class TPUKVStore(KVStore):
    """``kvstore='tpu'``: data parallelism over the default process group,
    one process a device. ``init`` takes rank 0's value, ``push`` sums over
    the ranks (in the gradient's dtype, on its device), ``barrier`` waits
    for every rank. Without a process group it is the in-process store."""

    def __init__(self, kv_type="tpu"):
        super().__init__(kv_type)
        self._mesh = None

    def attach_mesh(self, mesh):
        """Record the mesh the fused step's reductions run over (set by
        ``Module``)."""
        self._mesh = mesh

    @property
    def mesh(self):
        return self._mesh

    @staticmethod
    def _group():
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            return dist.group.WORLD
        return None

    def _sync_init(self, value):
        from .parallel.mesh import broadcast_

        broadcast_(value.tensor, self._group())
        return value

    def _sum_workers(self, agg):
        group = self._group()
        if group is None:
            return agg
        from .parallel.mesh import all_reduce_

        return NDArray(all_reduce_(agg.tensor.detach().clone(), group),
                       agg.context)

    @property
    def rank(self):
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self):
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    def barrier(self):
        import torch.distributed as dist

        nd.waitall()
        if self._group() is not None:
            dist.barrier()


_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "device", "local_allreduce_device", "nccl")


def create(name="local"):
    """A KVStore by type name: the ``local`` family, ``device`` and
    ``nccl`` are the in-process store, ``tpu`` (and ``dist_sync_tpu``) the
    data-parallel tier, ``dist_async`` with ``MXNET_PS_SERVER_URI`` set the
    parameter-server client; any other ``dist_*`` is not ported."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    if name in ("tpu", "dist_sync_tpu"):
        return TPUKVStore(name)
    if name.startswith("dist"):
        if name == "dist_async":
            uri = config.get("MXNET_PS_SERVER_URI")
            if uri:
                from .kvstore_server import ServerKVStore

                return ServerKVStore(uri, name)
            from . import tracker

            if tracker.tracker_env_spec() is not None:
                raise MXNetError(
                    "kvstore='dist_async' through the tracker's rendezvous "
                    "is not ported (ROADMAP.md Queue A item 10c): set "
                    "MXNET_PS_SERVER_URI to the servers' URIs")
        raise MXNetError("kvstore=%r is not ported (the multi-host tier: "
                         "dist_* over a launcher; ROADMAP.md Queue A item "
                         "10c)" % name)
    raise MXNetError("unknown kvstore type %r" % name)


__all__ = ["KVStore", "TPUKVStore", "create", "validate_compression_params",
           "two_bit_quantize", "two_bit_dequantize"]
