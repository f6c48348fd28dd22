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

``create("dist_async")`` with ``MXNET_PS_SERVER_URI`` set, or under the
scheduler topology (the tracker publishes the servers' URIs), is the
parameter-server tier's client, ``kvstore_server.ServerKVStore``.
``dist_sync``, ``dist_sync_device`` and a serverless ``dist_async`` are
:class:`DistKVStore`, the workers of one ``torch.distributed`` job
(:mod:`.dist`): pushes are deferred and cross at the first pull or barrier,
one flattened all-reduce a dtype (row-sparse ones as gathered ids and
values), and the updater runs alike on every worker.

2-bit gradient compression (``set_gradient_compression``) is the same on
every store: ``two_bit_pack_core`` and ``two_bit_round_trip_core`` are torch
functions on the tensor's device (the JAX cores bit for bit on fp32 and
bf16); the in-process stores round-trip each dense gradient through the
packed codes with an error-feedback residual a key, the server tier ships
the packed codes (``two_bit_quantize``/``two_bit_dequantize``, numpy).
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


def two_bit_pack_core(a, threshold):
    """2-bit pack of a tensor on its device: ternary threshold (compared
    and quantized in ``a``'s dtype), 4 codes a byte. Returns ``(packed
    uint8, quantized values)``."""
    t = torch.tensor(threshold, dtype=a.dtype, device=a.device)
    pos = a >= t
    neg = a <= -t
    quant = torch.where(pos, t, torch.where(neg, -t, torch.zeros_like(t)))
    codes = (pos.to(torch.uint8) | (neg.to(torch.uint8) << 1)).reshape(-1)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    q4 = codes.view(-1, 4)
    packed = q4[:, 0] | (q4[:, 1] << 2) | (q4[:, 2] << 4) | (q4[:, 3] << 6)
    return packed, quant


def two_bit_round_trip_core(g, res, threshold):
    """Quantize ``g + res`` and unpack it from the packed codes: the value
    ``g`` has after crossing the 2-bit wire, and the new residual."""
    a = g + res
    packed, quant = two_bit_pack_core(a, threshold)
    t = torch.tensor(threshold, dtype=a.dtype, device=a.device)
    codes = torch.stack([(packed >> (2 * j)) & 3 for j in range(4)],
                        dim=1).reshape(-1)[:a.numel()].view(a.shape)
    zero = torch.zeros_like(t)
    q = torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))
    return q, a - quant


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
        self._compression_params = None
        self._residuals = {}
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
        """Sum each key's values (one a context), round-trip the sum through
        the 2-bit wire when compression is set, then give it to the
        updater, or add it to the stored value."""
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("kvstore: key %r not initialized" % (k,))
            agg = self._reduce(vlist)
            if self._compression_params is not None:
                agg = self._compress_decompress(k, agg)
            agg = self._sum_workers(agg)
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
        """2-bit compression of each pushed dense gradient, with an
        error-feedback residual a key (reset here)."""
        self._compression_params = validate_compression_params(
            compression_params)
        self._residuals = {}

    def _compress_decompress(self, key, agg):
        """``agg`` after crossing the 2-bit wire: quantized, packed and
        unpacked on its device (``two_bit_round_trip_core``), the key's
        residual kept on the device for the next push."""
        g = agg.tensor.detach()
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(g)
        q, self._residuals[key] = two_bit_round_trip_core(
            g, res, self._compression_params["threshold"])
        return NDArray(q, agg.context)

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


class DistKVStore(TPUKVStore):
    """``dist_sync``, ``dist_sync_device`` and serverless ``dist_async``:
    the workers of one job (:mod:`.dist`, joined at construction).
    ``push`` sums a key's values (a dense sum round-trips through the 2-bit
    wire when compression is set; row-sparse ones stay raw) and defers;
    the first ``pull``, ``row_sparse_pull`` or ``barrier`` sends every
    pending key: dense ones as one flattened all-reduce a dtype on their
    device, row-sparse ones as the gathered ids and values of every worker
    (the union of their rows, duplicates summed). The updater then runs
    alike on every worker, so the stores stay bit for bit equal.
    ``dist_async`` gets the same synchronous semantics, and a warning says
    so. At exit a bounded barrier (``set_barrier_before_exit``) precedes
    the last flush."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        import atexit

        from . import dist

        if kv_type == "dist_async":
            import warnings

            warnings.warn(
                "kvstore 'dist_async' runs with synchronous semantics on "
                "the serverless tier (no stale-gradient tier); updates are "
                "collective and deterministic, matching dist_sync",
                stacklevel=3)
        dist.init_from_env()
        self._pending = {}
        atexit.register(self._exit_barrier)

    def _sync_init(self, value):
        return value

    def _sum_workers(self, agg):
        return agg

    @property
    def rank(self):
        from . import dist

        return dist.rank()

    @property
    def num_workers(self):
        from . import dist

        return dist.num_workers()

    def _exit_barrier(self):
        from . import dist

        # bounded first: with a dead peer the unbounded flush would hang
        if self._barrier_before_exit and dist.exit_barrier():
            self._flush()

    def num_dead_node(self, node_id=0, timeout=60):
        from . import dist

        return dist.get_num_dead_node(node_id, timeout)

    def push(self, key, value, priority=0):
        """Sum each key's values, compress a dense sum, and defer it to the
        next flush (a second push of a pending key flushes the first)."""
        from .ndarray.sparse import RowSparseNDArray

        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("kvstore: key %r not initialized" % (k,))
            if k in self._pending:
                self._flush()
            agg = self._reduce(vlist)
            # snapshots: the caller may reuse its buffers before the flush
            if isinstance(agg, RowSparseNDArray):
                self._pending[k] = (
                    "rsp", agg.data.tensor.detach().clone(),
                    agg.indices.tensor.detach().long().reshape(-1).clone(),
                    tuple(agg.shape), agg.context)
            else:
                if self._compression_params is not None:
                    agg = self._compress_decompress(k, agg)
                self._pending[k] = ("dense", agg.tensor.detach().clone(),
                                    agg.context)

    @staticmethod
    def _all_reduce(t):
        from . import dist

        if dist.is_initialized() and dist.num_workers() > 1:
            import torch.distributed as tdist

            tdist.all_reduce(t)
        return t

    def _apply(self, k, agg):
        store = self._store[k]
        if agg.context != store.context:
            agg = agg.copyto(store.context)
        if self._updater is not None:
            self._updater(k, agg, store)
        else:
            store += agg

    def _flush(self):
        """Send every pending key across the workers and apply it."""
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        rsp = {k: v for k, v in pending.items() if v[0] == "rsp"}
        if rsp:
            self._flush_row_sparse(rsp)
        by_dtype = {}
        for k, v in pending.items():
            if v[0] == "dense":
                by_dtype.setdefault((v[1].dtype, v[1].device), []).append(k)
        with torch.no_grad():
            for keys in by_dtype.values():
                ts = [pending[k][1] for k in keys]
                flat = self._all_reduce(
                    torch.cat([t.reshape(-1) for t in ts]))
                off = 0
                for k, t in zip(keys, ts):
                    n = t.numel()
                    agg = flat[off:off + n].view(t.shape).clone()
                    off += n
                    self._apply(k, NDArray(agg, pending[k][2]))

    def _flush_row_sparse(self, rsp):
        """Every worker's row ids and values of the pending row-sparse
        keys, gathered on the host (one gather of the row counts, one of
        the ids, one of the values a dtype), then each key's union of rows
        with duplicates summed, to the updater or added to the store."""
        from . import dist
        from .ndarray import sparse as nd_sparse
        from .ndarray.sparse import RowSparseNDArray

        keys = sorted(rsp, key=str)
        my_nnz = np.asarray([rsp[k][2].numel() for k in keys], np.int64)
        nnz_all = np.asarray(dist.allgather(my_nnz), np.int64)   # (W, K)
        nworkers = nnz_all.shape[0]
        max_ids = max(int(nnz_all.sum(axis=1).max()), 1)
        ids = torch.full((max_ids,), -1, dtype=torch.int64)
        mine = torch.cat([rsp[k][2].cpu() for k in keys])
        ids[:mine.numel()] = mine
        all_ids = dist.allgather(ids)
        widths = {k: int(np.prod(rsp[k][3][1:])) for k in keys}
        all_vals = {}
        for dt in sorted({rsp[k][1].dtype for k in keys}, key=str):
            dt_keys = [k for k in keys if rsp[k][1].dtype == dt]
            tot = max(int(sum(nnz_all[:, keys.index(k)] * widths[k]
                              for k in dt_keys).max()), 1)
            buf = torch.zeros((tot,), dtype=dt)
            flat = torch.cat([rsp[k][1].reshape(-1).cpu() for k in dt_keys])
            buf[:flat.numel()] = flat
            all_vals[dt] = dist.allgather(buf)
        id_off = np.zeros((nworkers,), np.int64)
        val_off = {dt: np.zeros((nworkers,), np.int64) for dt in all_vals}
        for i, k in enumerate(keys):
            _tag, vals, _ids, shape, ctx = rsp[k]
            id_parts, val_parts = [], []
            for w in range(nworkers):
                n = int(nnz_all[w, i])
                io, vo = int(id_off[w]), int(val_off[vals.dtype][w])
                id_parts.append(all_ids[w, io:io + n])
                val_parts.append(all_vals[vals.dtype][w, vo:vo + n * widths[k]]
                                 .view((n,) + tuple(shape[1:])))
                id_off[w] += n
                val_off[vals.dtype][w] += n * widths[k]
            dev = vals.device
            m_vals, m_ids = nd_sparse._canonicalize(
                torch.cat(val_parts).to(dev), torch.cat(id_parts).to(dev))
            agg = RowSparseNDArray(NDArray(m_vals, ctx),
                                   NDArray(m_ids.long(), ctx), shape, ctx=ctx)
            if self._updater is not None:
                self._updater(k, agg, self._store[k])
            else:
                self._accumulate_rsp(k, agg)

    def _accumulate_rsp(self, k, agg):
        """``store[k] += agg`` for a row-sparse ``agg``."""
        from .ndarray import sparse as nd_sparse
        from .ndarray.sparse import RowSparseNDArray

        store = self._store[k]
        if isinstance(store, RowSparseNDArray):
            self._store[k] = nd_sparse.add(store, agg)
            return
        t = store.tensor
        with torch.no_grad():
            t.index_add_(0, agg.indices.tensor.to(t.device).long(),
                         agg.data.tensor.to(t.device, t.dtype))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        self._flush()
        super().pull(key, out=out, priority=priority,
                     ignore_sparse=ignore_sparse)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        self._flush()
        return super().row_sparse_pull(key, out=out, priority=priority,
                                       row_ids=row_ids)

    def barrier(self):
        from . import dist

        self._flush()
        nd.waitall()
        dist.barrier()


_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "device", "local_allreduce_device", "nccl")


def create(name="local"):
    """A KVStore by type name: the ``local`` family, ``device`` and
    ``nccl`` are the in-process store, ``tpu`` (and ``dist_sync_tpu``) the
    data-parallel tier; ``dist_async`` with ``MXNET_PS_SERVER_URI`` set, or
    under the scheduler topology, the parameter-server client; any other
    ``dist_*`` (and a serverless ``dist_async``) :class:`DistKVStore`."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    if name in ("tpu", "dist_sync_tpu"):
        return TPUKVStore(name)
    if name.startswith("dist"):
        from . import tracker

        if name == "dist_async":
            uri = config.get("MXNET_PS_SERVER_URI")
            if uri:
                from .kvstore_server import ServerKVStore

                return ServerKVStore(uri, name)
            if tracker.tracker_env_spec() is not None:
                # the scheduler published every server's URI
                from .kvstore_server import ServerKVStore

                try:
                    uris = tracker.discover_server_uris()
                except tracker.TrackerError as e:
                    raise MXNetError(
                        "dist_async: scheduler rendezvous failed: %s" % e)
                return ServerKVStore(uris, name,
                                     tracker_client=tracker.worker_client())
        elif tracker.tracker_env_spec() is not None:
            raise MXNetError(
                "kvstore %r has no synchronization path under the "
                "scheduler topology (launch.py -s > 0): workers "
                "would train unsynchronized. Use --kv-store "
                "dist_async (parameter-server tier) or launch with "
                "-s 0 for the serverless collective path" % name)
        return DistKVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)


__all__ = ["KVStore", "TPUKVStore", "DistKVStore", "create",
           "validate_compression_params", "two_bit_pack_core",
           "two_bit_round_trip_core", "two_bit_quantize",
           "two_bit_dequantize"]
