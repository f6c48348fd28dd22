"""The multi-process runtime over ``torch.distributed`` (counterpart of
``mxnet_tpu/dist.py``): rendezvous from the launcher's environment, host
collectives, the global mesh and failure detection.

Every worker process joins one default process group at the coordinator
(``tcp://<coordinator>``; rank 0 hosts its store). The environment is the
JAX package's, set by ``tools/launch.py -s 0``:

- ``MXNET_TPU_COORDINATOR``  host:port (else ``DMLC_PS_ROOT_URI``/``PORT``)
- ``MXNET_TPU_NUM_WORKERS``  int       (``DMLC_NUM_WORKER``)
- ``MXNET_TPU_WORKER_RANK``  int       (``DMLC_WORKER_ID``)

Under the scheduler topology (``DMLC_NUM_SERVER > 0``) the root URI is the
tracker's, so :func:`env_spec` gives None and the serverless path stays out.

Backends: host arrays (:func:`allreduce`, :func:`allgather`,
:func:`broadcast0`, :func:`barrier`) cross on gloo. Card tensors cross on
NCCL when each worker of this host has a card of its own, and on gloo when
workers share a card (NCCL refuses two ranks on one GPU): the group's
backend is then ``"cpu:gloo,cuda:nccl"`` or ``"gloo"``, and
:func:`backend` names it. A failed NCCL init raises; nothing falls back.

Failure detection: each rank sets a heartbeat key of the group's store
(``mxtpu_hb/<rank>``, its wall clock, every ``HEARTBEAT_INTERVAL``
seconds). :func:`live_workers` calls a rank dead once its heartbeat is
older than ``timeout`` seconds; :func:`exit_barrier` is a bounded barrier
on the store. All ranks count as alive when the process runs alone or the
store cannot be reached.
"""
from __future__ import annotations

import os
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as tdist

from .base import MXNetError

#: seconds between a rank's heartbeats
HEARTBEAT_INTERVAL = 1.0

_INITIALIZED = False
_HEARTBEAT = None        # the heartbeat thread's stop event
_EXIT_GEN = [0]          # exit barriers run so far (each has its own key)


def env_spec():
    """The launcher's ``(coordinator, num_workers, rank)``, or None."""
    coord = os.environ.get("MXNET_TPU_COORDINATOR")
    if coord is None and os.environ.get("DMLC_PS_ROOT_URI"):
        if int(os.environ.get("DMLC_NUM_SERVER", "0") or 0) > 0:
            # scheduler topology: the root URI is the tracker's endpoint,
            # which the server tier owns
            return None
        coord = "%s:%s" % (os.environ["DMLC_PS_ROOT_URI"],
                           os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    num = os.environ.get("MXNET_TPU_NUM_WORKERS",
                         os.environ.get("DMLC_NUM_WORKER"))
    rank_ = os.environ.get("MXNET_TPU_WORKER_RANK",
                           os.environ.get("DMLC_WORKER_ID"))
    if coord is None or num is None or rank_ is None:
        return None
    return coord, int(num), int(rank_)


def _local_workers(coord, num):
    """Workers on this host: ``LOCAL_WORLD_SIZE`` when set, else all of
    them for a loopback coordinator (one host), else one."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env:
        return int(env)
    host = coord.rsplit(":", 1)[0]
    return num if host in ("127.0.0.1", "localhost", "::1") else 1


def _choose_backend(coord, num):
    """``gloo`` without a card or when this host's workers share one;
    ``cpu:gloo,cuda:nccl`` when each has its own."""
    if not torch.cuda.is_available():
        return "gloo"
    if _local_workers(coord, num) > torch.cuda.device_count():
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def init_from_env(timeout=None):
    """Join the launcher's job (idempotent): the default process group at
    ``tcp://<coordinator>`` with the rank and world size of the
    environment, or the group that exists already (its rank and size must
    agree). Returns True when running multi-process, False alone."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    spec = env_spec()
    if spec is None:
        return False
    coord, num, rank_ = spec
    if num <= 1:
        return False
    if tdist.is_initialized():
        if tdist.get_world_size() != num or tdist.get_rank() != rank_:
            raise MXNetError(
                "dist.init_from_env: the process group has rank %d of %d, "
                "the launcher's environment rank %d of %d"
                % (tdist.get_rank(), tdist.get_world_size(), rank_, num))
    else:
        kwargs = {}
        if timeout is not None:
            kwargs["timeout"] = timedelta(seconds=float(timeout))
        tdist.init_process_group(_choose_backend(coord, num),
                                 init_method="tcp://%s" % coord,
                                 rank=rank_, world_size=num, **kwargs)
    _INITIALIZED = True
    _start_heartbeat()
    return True


def is_initialized():
    return _INITIALIZED


def backend():
    """The process group's backend (``gloo``, ``cpu:gloo,cuda:nccl``), or
    None without one."""
    if not tdist.is_initialized():
        return None
    return str(tdist.get_backend())


def rank():
    return tdist.get_rank() if tdist.is_initialized() else 0


def num_workers():
    return tdist.get_world_size() if tdist.is_initialized() else 1


def global_mesh(axes=None, device=None):
    """The global mesh over every worker, hosts on the outermost ``dcn``
    axis. ``axes`` (``{name: size}``, -1 for the rest) lays out the
    process's own devices: one a process in the port, so their sizes
    multiply to 1 (default ``{"dp": 1}``). Multi-process the mesh is
    ``("dcn",) + axes`` of shape ``(num_workers, 1, ...)``; alone it is
    ``axes``. ``device``: None (the card) or ``"cpu"``."""
    from .parallel.mesh import make_mesh

    axes = dict(axes or {"dp": 1})
    sizes = [1 if s == -1 else int(s) for s in axes.values()]
    if int(np.prod(sizes)) != 1:
        raise MXNetError("global_mesh: axes %r must use all 1 local "
                         "devices (one process a device)" % (axes,))
    axes = {k: 1 for k in axes}
    n = num_workers()
    if n > 1:
        return make_mesh(dict({"dcn": n}, **axes), device=device)
    return make_mesh(axes, device=device)


# ---------------------------------------------------------------------------
# host collectives (gloo)
# ---------------------------------------------------------------------------
def _multi():
    return _INITIALIZED and num_workers() > 1


def _host_tensor(value):
    return torch.from_numpy(np.ascontiguousarray(value).copy())


def allreduce(value, op="sum"):
    """A host numpy array reduced over every worker (``op``: sum or max);
    the result is the same on every worker."""
    value = np.asarray(value)
    if not _multi():
        return value
    red = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    t = _host_tensor(value)
    tdist.all_reduce(t, op=red)
    return t.numpy().reshape(value.shape)


def allgather(value):
    """Every worker's host array stacked on a leading worker axis,
    ``(num_workers, ...)``, the same on every worker: a numpy array or a
    host tensor (any dtype, bfloat16 too), returned as the same kind."""
    is_tensor = isinstance(value, torch.Tensor)
    t = value.detach().contiguous() if is_tensor else \
        _host_tensor(np.asarray(value))
    if _multi():
        parts = [torch.empty_like(t) for _ in range(num_workers())]
        tdist.all_gather(parts, t)
        t = torch.stack(parts)
    else:
        t = t[None]
    return t if is_tensor else t.numpy()


def broadcast0(value):
    """Rank 0's array on every worker, bit for bit for every dtype (its
    bytes cross): a numpy array or a tensor, returned as the same kind."""
    if not _multi():
        return value
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous().clone()
        raw = t.reshape(-1).view(torch.uint8)
        tdist.broadcast(raw, src=0)
        return raw.view(t.dtype).reshape(t.shape).to(value.device)
    arr = np.ascontiguousarray(np.asarray(value))
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    tdist.broadcast(raw, src=0)
    return raw.numpy().view(arr.dtype).reshape(arr.shape)


def barrier():
    """Wait until every worker reaches it."""
    if _multi():
        allreduce(np.zeros((1,), np.float32))


# ---------------------------------------------------------------------------
# failure detection on the group's store
# ---------------------------------------------------------------------------
def _store():
    try:
        from torch.distributed.distributed_c10d import _get_default_store

        return _get_default_store()
    except Exception:
        return None


def _start_heartbeat():
    """Set this rank's heartbeat key now and every HEARTBEAT_INTERVAL
    seconds, on a daemon thread that ends at the first store failure."""
    global _HEARTBEAT
    store = _store()
    if store is None or _HEARTBEAT is not None:
        return
    key = "mxtpu_hb/%d" % rank()
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            try:
                store.set(key, repr(time.time()))
            except Exception:
                return
            stop.wait(HEARTBEAT_INTERVAL)

    try:
        store.set(key, repr(time.time()))
    except Exception:
        return
    threading.Thread(target=beat, name="mxtpu-heartbeat",
                     daemon=True).start()
    _HEARTBEAT = stop


def live_workers(timeout=60):
    """``{rank: alive}``: a rank is dead once its last heartbeat is older
    than ``timeout`` seconds. All alive alone, or when the store cannot be
    reached."""
    n = num_workers() if _INITIALIZED else 1
    store = _store() if _INITIALIZED else None
    if store is None or n == 1:
        return {r: True for r in range(n)}
    now = time.time()
    out = {}
    try:
        for r in range(n):
            key = "mxtpu_hb/%d" % r
            if not store.check([key]):
                out[r] = True     # not started yet: not dead
                continue
            out[r] = now - float(store.get(key).decode()) <= timeout
    except Exception:
        return {r: True for r in range(n)}
    return out


def get_num_dead_node(node_id=0, timeout=60):
    """Dead workers (``KVStore::get_num_dead_node``): ranks without a
    heartbeat for ``timeout`` seconds. ``node_id`` is kept for the API."""
    del node_id
    return sum(1 for alive in live_workers(timeout).values() if not alive)


def exit_barrier(timeout_ms=10000):
    """A barrier before exit bounded by ``timeout_ms``, so a dead worker
    cannot hang the others' shutdown: True when every worker arrived."""
    if not _INITIALIZED:
        return True
    store = _store()
    if store is None:
        return True
    _EXIT_GEN[0] += 1
    key = "mxtpu_exit_barrier/%d" % _EXIT_GEN[0]
    deadline = time.monotonic() + timeout_ms / 1000.0
    try:
        arrived = store.add(key, 1)
        while arrived < num_workers():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
            arrived = store.add(key, 0)
    except Exception:
        return False
    return True


__all__ = ["env_spec", "init_from_env", "is_initialized", "backend", "rank",
           "num_workers", "global_mesh", "allreduce", "allgather",
           "broadcast0", "barrier", "live_workers", "get_num_dead_node",
           "exit_barrier"]
