"""Placing batches on a data-parallel mesh (counterpart of
``mxnet_tpu/parallel/feed.py``): ``is_preplaced``, ``place_batch_array``
and :class:`DeviceQueueIter`, the background feed.

A placed array is this rank's rows of the global batch, on the rank's
device, tagged with the :class:`~.spmd.Sharding` it was placed for, as a
JAX array carries its sharding (on a one-process mesh, the global host
array holding every replica's rows on its device); ``TrainStep`` and
``FusedSPMDGroup`` take such an array as it is. :class:`DeviceQueueIter`
places each batch of a host iterator on a background thread, a bounded
queue ahead of the consumer.

``distributed=True`` (the workers of a launcher's job, ``dist_*``): each
worker's array is its own rows of the global batch, placed as they are.
:class:`DeviceQueueIter` then holds the workers' local row counts equal by
one collective on the consumer's thread at the first batch, and raises
when a later batch's count changes.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings

import numpy as np
import torch

from .. import profiler
from ..base import MXNetError
from ..io import DataBatch, DataIter
from ..ndarray.ndarray import NDArray


def expected_sharding(mesh, data_axes):
    """The sharding of a batch array on this mesh's data axes: the step's
    own (``spmd.data_sharding``)."""
    from .spmd import data_sharding

    return data_sharding(mesh, data_axes)


def is_preplaced(value, sharding):
    """True when ``value`` was placed for ``sharding`` already."""
    return getattr(value, "_mx_sharding", None) == sharding


def rank_rows(value, n, index, name, what):
    """Rows ``[index * B / n, (index + 1) * B / n)`` of a global batch
    array of ``B`` rows (a view); ``what`` names the caller in the error
    when ``n`` does not divide ``B``."""
    rows = int(value.shape[0])
    if rows % n:
        raise MXNetError("%s: batch dim %d of %r not divisible by %d "
                         "data-parallel ranks" % (what, rows, name, n))
    b = rows // n
    return value[index * b:(index + 1) * b]


def place_batch_array(mesh, data_axes, distributed, name, value,
                      sharding=None):
    """A host batch array (numpy or a tensor) of the global batch -> this
    rank's rows on its device, tagged with ``sharding``; under
    ``distributed`` the array is this worker's rows already and is placed
    whole. Arrays placed already pass through. Records bytes and time in
    the profiler's pipeline counters."""
    from .mesh import data_group, is_local, mesh_device

    sharding = sharding or expected_sharding(mesh, data_axes)
    if is_preplaced(value, sharding):
        profiler.h2d_record(preplaced=1)
        return value
    t0 = time.perf_counter()
    if is_local(mesh):
        return _place_local(mesh, data_axes, name, value, sharding, t0)
    if distributed:
        rows = value
    else:
        _group, n, index = data_group(mesh, data_axes)
        rows = rank_rows(value, n, index, name, "async feed")
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    out = rows.to(mesh_device(mesh))   # a new tensor object (a slice)
    out._mx_sharding = sharding
    profiler.h2d_record(nbytes=out.numel() * out.element_size(), puts=1,
                        seconds=time.perf_counter() - t0)
    return out


def _place_local(mesh, data_axes, name, value, sharding, t0):
    """A global batch array placed on a one-process mesh: the host array
    (a new tensor object) tagged with ``sharding``, holding each replica's
    rows on its device in ``_mx_replicas``, each tagged with the replica's
    own sharding (``TrainStep`` over the mesh hands replica ``i`` its
    rows)."""
    from .mesh import data_group

    host = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(value))
    parts, nbytes = [], 0
    for i in range(mesh.size):
        replica = mesh.replica(i)
        _group, n, index = data_group(replica, data_axes)
        rows = rank_rows(host, n, index, name, "async feed").to(
            replica.device)
        rows._mx_sharding = expected_sharding(replica, data_axes)
        parts.append(rows)
        nbytes += rows.numel() * rows.element_size()
    out = host[:]
    out._mx_sharding = sharding
    out._mx_replicas = parts
    profiler.h2d_record(nbytes=nbytes, puts=len(parts),
                        seconds=time.perf_counter() - t0)
    return out


_END = object()    # inner iterator exhausted
_ABORT = object()  # worker thread died; see self._exc


class DeviceQueueIter(DataIter):
    """Wrap any :class:`DataIter` so batches arrive on the card already
    placed for the mesh, converted on a background thread while the
    previous step computes.

    Parameters
    ----------
    data_iter : DataIter
        The host-side source iterator.
    group : FusedSPMDGroup, optional
        Take ``mesh``/``data_axes``/``distributed`` from a Module's fused
        group directly.
    module : Module, optional
        Bind lazily to ``module``'s fused group: resolution happens on
        the first ``next()``, which in ``Module.fit`` is after
        ``init_optimizer`` created the group — so the wrapper can be
        built BEFORE ``fit`` is called. When the module has no fused
        group (kvstore is not 'tpu'/'dist_*'), the iterator degrades to
        a transparent pass-through of host batches (with a warning).
    mesh, data_axes, distributed :
        Explicit placement spec when neither group nor module is given.
    depth : int
        Bounded pipeline depth (batches staged on device ahead of the
        consumer). Default ``MXNET_TPU_FEED_DEPTH`` (2).
    close_source : bool
        Whether :meth:`close` also closes ``data_iter``. Default True;
        auto-wrappers around a CALLER-owned iterator (``FeedForward.fit``)
        pass False so the caller can keep using it.

    Supports ``with DeviceQueueIter(...) as it:`` and explicit
    :meth:`close`; ``reset()`` restarts cleanly after ``StopIteration``
    or mid-epoch abandonment.
    """

    def __init__(self, data_iter, group=None, module=None, mesh=None,
                 data_axes=("dp",), distributed=False, depth=None,
                 close_source=True):
        super().__init__(getattr(data_iter, "batch_size", 0))
        from .. import config

        if depth is None:
            depth = config.get("MXNET_TPU_FEED_DEPTH")
        depth = int(depth)
        if depth < 1:
            raise MXNetError(
                "DeviceQueueIter: depth must be >= 1 (got %d); set "
                "MXNET_TPU_FEED_DEPTH to a positive integer" % depth)
        self.data_iter = data_iter
        self.depth = depth
        self._close_source = bool(close_source)
        self._module = module
        self._passthrough = False
        self._group = None
        self.mesh = None
        self._closed = False
        self._thread = None
        self._q = None
        self._exc = None
        self._stop = threading.Event()
        self._current_batch = None
        self._local_rows = None
        self._checked_agreement = False
        if group is not None or mesh is not None:
            self._bind(group=group, mesh=mesh, data_axes=data_axes,
                       distributed=distributed)
        elif module is None:
            raise MXNetError(
                "DeviceQueueIter: need a mesh (or group=/module=)")
        # module= defers binding to the first next()

    def _bind(self, group=None, mesh=None, data_axes=("dp",),
              distributed=False):
        if group is not None:
            mesh = group.mesh
            data_axes = group._data_axes
            distributed = getattr(group, "distributed", False)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.distributed = bool(distributed)
        self._sharding = expected_sharding(mesh, self.data_axes)
        self._group = group

    def _ensure_started(self):
        """Resolve deferred module binding and start the worker."""
        if self._thread is not None or self._passthrough:
            return
        if self.mesh is None:
            fused = getattr(self._module, "_fused", None)
            if fused is None:
                warnings.warn(
                    "DeviceQueueIter: module has no fused SPMD group "
                    "(kvstore != 'tpu'); passing host batches through "
                    "unchanged", stacklevel=3)
                self._passthrough = True
                return
            self._bind(group=fused)
        self._start()

    # -- pass-through metadata ----------------------------------------------
    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    # -- worker --------------------------------------------------------------
    def _start(self):
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._exc = None
        # the worker binds THIS generation's queue/stop-event as locals:
        # a reset() that times out joining a wedged worker replaces both,
        # and the abandoned thread must never be able to inject a stale
        # pre-reset batch into the new epoch's queue
        t = threading.Thread(target=self._worker,
                             args=(self._q, self._stop),
                             name="DeviceQueueIter", daemon=True)
        self._thread = t
        t.start()

    @staticmethod
    def _put(q, stop, item):
        """Queue.put that stays responsive to close()/reset()."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _place_batch(self, batch):
        rows = None

        def place(name, arr):
            nonlocal rows
            value = arr.tensor if isinstance(arr, NDArray) else arr
            if rows is None and not is_preplaced(value, self._sharding):
                rows = int(value.shape[0])
            placed = place_batch_array(
                self.mesh, self.data_axes, self.distributed, name, value,
                sharding=self._sharding)
            return NDArray(placed)

        names_d = [d[0] if isinstance(d, tuple) else d.name
                   for d in (self.provide_data or [])]
        names_l = [d[0] if isinstance(d, tuple) else d.name
                   for d in (self.provide_label or [])]
        data = [place(names_d[i] if i < len(names_d) else "data%d" % i, a)
                for i, a in enumerate(batch.data or [])]
        label = [place(names_l[i] if i < len(names_l) else "label%d" % i, a)
                 for i, a in enumerate(batch.label or [])]
        if self.distributed and rows is not None:
            if self._local_rows is None:
                self._local_rows = rows
            elif rows != self._local_rows:
                raise MXNetError(
                    "DeviceQueueIter: local batch size changed mid-stream "
                    "(%d -> %d); pad or discard the tail batch so every "
                    "rank keeps a constant shape" % (self._local_rows, rows))
        return DataBatch(data, label or None, pad=batch.pad,
                         index=batch.index,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)

    def _worker(self, q, stop):
        try:
            while not stop.is_set():
                try:
                    batch = self.data_iter.next()
                except StopIteration:
                    self._put(q, stop, _END)
                    return
                placed = self._place_batch(batch)
                profiler.h2d_record(batches=1, queue_depth=q.qsize())
                if not self._put(q, stop, placed):
                    return
        except BaseException as e:  # surfaced on the consumer thread
            self._exc = e
            self._put(q, stop, _ABORT)

    # -- consumer ------------------------------------------------------------
    def next(self):
        if self._closed:
            raise MXNetError("DeviceQueueIter: iterator is closed")
        self._ensure_started()
        if self._passthrough:
            return self.data_iter.next()
        t0 = time.perf_counter()
        item = self._q.get()
        profiler.h2d_record(stall_feed=time.perf_counter() - t0)
        if item is _END:
            # leave a sentinel for repeated next() calls post-epoch
            self._q.put(_END)
            raise StopIteration
        if item is _ABORT:
            self._q.put(_ABORT)  # repeated next() keeps raising
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        if self.distributed and not self._checked_agreement:
            self._check_agreement()
        self._current_batch = item
        return item

    def _check_agreement(self):
        """One collective on the consumer's thread at the first batch (a
        collective on the worker thread would interleave with the step's):
        every worker's local rows must agree. Later batches keep the count
        (``_place_batch`` raises on a change)."""
        from .. import dist

        if dist.num_workers() > 1 and self._local_rows is not None:
            if self._group is not None:
                self._group._check_local_batch_agreement([self._local_rows])
            else:
                mine = np.asarray([self._local_rows], np.int64)
                rows = dist.allgather(mine)
                if not (rows == mine[None, :]).all():
                    raise MXNetError(
                        "DeviceQueueIter: local batch size %d differs "
                        "across workers (per-rank sizes %s); pad or "
                        "discard the tail batch so every rank agrees"
                        % (self._local_rows, rows.reshape(-1).tolist()))
        self._checked_agreement = True

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current_batch.data

    def getlabel(self):
        return self._current_batch.label

    def getindex(self):
        return self._current_batch.index

    def getpad(self):
        return self._current_batch.pad

    # -- lifecycle -----------------------------------------------------------
    def _shutdown(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            # drain so a worker blocked in put() can observe the stop
            # flag; bounded — a worker wedged inside the SOURCE
            # iterator's next() is a daemon thread and may be abandoned
            deadline = time.monotonic() + timeout
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        self._thread = None

    def reset(self):
        """Restart from the top of the (reset) source iterator — valid
        after StopIteration AND after abandoning an epoch mid-stream."""
        if self._closed:
            raise MXNetError("DeviceQueueIter: iterator is closed")
        if self._passthrough or self._thread is None:
            self.data_iter.reset()
            return
        self._shutdown()
        self.data_iter.reset()
        self._current_batch = None
        self._start()

    def close(self):
        """Stop the worker, drop queued device batches, close the source
        iterator if it supports close() (unless built with
        ``close_source=False``). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._shutdown()
        self._q = queue.Queue()  # drop device-batch references
        self._current_batch = None
        if self._close_source:
            inner_close = getattr(self.data_iter, "close", None)
            if callable(inner_close):
                inner_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
