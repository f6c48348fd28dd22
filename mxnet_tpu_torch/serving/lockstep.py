"""The control plane of a predictor sharded over a mesh, one process a rank
(``GenerativePredictor(mesh=)``, ``AOTPredictor(mesh=)``).

The mesh's global rank 0 (the leader) serves. Before each call it
broadcasts an op and the call's arrays over a gloo group of its own (CPU
tensors, whatever backend the mesh's collectives run on); every other rank
receives them in :meth:`Lockstep.follow` and runs the same call, so the
collectives inside it meet. With dp > 1 every mp group computes the same
call. A call is two broadcasts: a fixed header (the op, then each array's
dtype and shape) and one byte buffer holding every array.
"""
from __future__ import annotations

import datetime
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Lockstep", "CLOSE"]

# op 0 on the wire releases the followers
CLOSE = 0
# the dtypes an array may have on the wire, by code
_DTYPES = tuple(np.dtype(t) for t in (
    np.int64, np.int32, np.float32, np.float64, np.float16, np.uint8,
    np.int8, np.bool_))
_MAX_ARRAYS, _MAX_DIMS = 8, 6
_SLOT = 2 + _MAX_DIMS             # dtype code, ndim, then the dims
_HEADER = 2 + _MAX_ARRAYS * _SLOT  # op, array count, then a slot an array
# the leader's sends give up after this long (a follower that died closes
# its connections, which fails a send at once); a follower waits for the
# next call as long as the leader lives
_SEND_TIMEOUT = datetime.timedelta(seconds=60)
_WAIT_TIMEOUT = datetime.timedelta(days=30)


class Lockstep:
    """One sharded predictor's lockstep; ``error`` is the exception class
    its calls raise. ``closed`` and ``broken`` (the error that broke it)
    are read by the predictor; a shared lock orders every call the
    predictors on this lockstep make (a self-draft shares its target's)."""

    def __init__(self, error):
        self.error = error
        self.leader = dist.get_rank() == 0
        self.group = dist.new_group(backend="gloo", timeout=_SEND_TIMEOUT)
        self.closed = False
        self.broken = None
        self.lock = threading.RLock()

    def _bcast(self, t, timeout):
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor, opts.timeout = 0, 0, timeout
        self.group.broadcast([t], opts).wait()

    def send(self, op, arrays):
        """Broadcast ``op`` and ``arrays`` (numpy, of a dtype in
        ``_DTYPES``) to the mesh."""
        if len(arrays) > _MAX_ARRAYS:
            raise self.error("lockstep: %d arrays in one call, at most %d"
                             % (len(arrays), _MAX_ARRAYS))
        header = np.zeros(_HEADER, np.int64)
        header[:2] = op, len(arrays)
        flat = []
        for i, a in enumerate(arrays):
            a = np.ascontiguousarray(a)
            if a.dtype not in _DTYPES or a.ndim > _MAX_DIMS:
                raise self.error("lockstep: cannot send an array of dtype "
                                 "%s and %d dims" % (a.dtype, a.ndim))
            at = 2 + i * _SLOT
            header[at:at + 2] = _DTYPES.index(a.dtype), a.ndim
            header[at + 2:at + 2 + a.ndim] = a.shape
            flat.append(a.reshape(-1).view(np.uint8))
        self._bcast(torch.from_numpy(header), _SEND_TIMEOUT)
        if flat:
            self._bcast(torch.from_numpy(np.concatenate(flat)),
                        _SEND_TIMEOUT)

    def recv(self):
        """``(op, arrays)`` of the leader's next :meth:`send`."""
        header = torch.zeros(_HEADER, dtype=torch.int64)
        self._bcast(header, _WAIT_TIMEOUT)
        header = header.numpy()
        op, n = int(header[0]), int(header[1])
        metas = []
        for i in range(n):
            at = 2 + i * _SLOT
            dtype = _DTYPES[int(header[at])]
            shape = tuple(int(d) for d in header[at + 2:at + 2
                                                 + int(header[at + 1])])
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            metas.append((dtype, shape, nbytes))
        arrays = []
        if n:
            buf = torch.zeros(sum(m[2] for m in metas), dtype=torch.uint8)
            self._bcast(buf, _SEND_TIMEOUT)
            raw, off = buf.numpy(), 0
            for dtype, shape, nbytes in metas:
                # a copy: each array aligned for its dtype
                arrays.append(raw[off:off + nbytes].view(dtype)
                              .reshape(shape).copy())
                off += nbytes
        return op, arrays

    def lead(self, name, op, arrays, run):
        """On the leader: broadcast ``op`` and ``arrays``, then ``run()``
        here and return its result. Any failure breaks the lockstep: later
        calls raise."""
        with self.lock:
            if not self.leader:
                raise self.error(
                    "%s: only the mesh's rank 0 calls a sharded predictor; "
                    "the other ranks run follow()" % name)
            if self.closed or self.broken is not None:
                raise self.error("%s: the sharded predictor is %s"
                                 % (name, "closed" if self.closed
                                    else "broken: %s" % self.broken))
            try:
                self.send(op, arrays)
                return run()
            except Exception as e:
                self.broken = e
                raise self.error("%s: a sharded call failed (the lockstep "
                                 "is broken): %s" % (name, e)) from e

    def follow(self, handle):
        """On a follower: ``handle(op, arrays)`` for each of the leader's
        calls, until the leader closes the lockstep."""
        if self.leader:
            raise self.error("follow: only the ranks but 0 of a sharded "
                             "predictor follow")
        while True:
            op, arrays = self.recv()
            if op == CLOSE:
                self.closed = True
                return
            handle(op, arrays)

    def close(self):
        """On the leader, release the followers; later calls raise. A no-op
        on a follower and once closed; after a failed call nothing is
        sent."""
        with self.lock:
            if not self.leader or self.closed:
                return
            self.closed = True
            if self.broken is None:
                try:
                    self.send(CLOSE, ())
                except Exception as e:      # a follower is gone
                    self.broken = e
