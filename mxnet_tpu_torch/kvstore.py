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

Not ported, raising by name: gradient compression
(``set_gradient_compression``), the ``dist_*`` types and row-sparse pulls.
"""
from __future__ import annotations

import os

from .base import MXNetError
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray


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
        raise MXNetError("kvstore.row_sparse_pull: sparse arrays are not "
                         "ported")

    @staticmethod
    def _reduce(vlist):
        """The sum of one key's values, on the first value's device."""
        if len(vlist) == 1:
            return vlist[0]
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
        raise MXNetError("kvstore.set_gradient_compression: gradient "
                         "compression is not ported")

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
        """The updater's states, written to a temporary file and
        renamed."""
        if self._updater is None:
            raise MXNetError("kvstore: no updater to save")
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)

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
    data-parallel tier; ``dist_*`` is not ported."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    if name in ("tpu", "dist_sync_tpu"):
        return TPUKVStore(name)
    if name.startswith("dist"):
        raise MXNetError("kvstore=%r is not ported (the multi-host tier: "
                         "dist_* over a launcher)" % name)
    raise MXNetError("unknown kvstore type %r" % name)


__all__ = ["KVStore", "TPUKVStore", "create"]
