"""Pooled host storage (counterpart of ``mxnet_tpu/storage.py``).

MXNet's ``Storage::Alloc``/``Free`` over a pooled manager. The card's
memory belongs to torch's caching allocator; this pool recycles host
staging buffers (input batches, record scratch, checkpoint shards)
through the native allocator of ``src/storage.cc``, built by
:mod:`._native`.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _native, config
from .base import MXNetError

__all__ = ["StoragePool", "default_pool"]


class StoragePool:
    """A recycling allocator over the native pool, bucketed by size."""

    def __init__(self, max_cached_bytes=1 << 30):
        lib = _native.get_lib()
        if lib is None:
            raise MXNetError("native runtime unavailable: %s"
                             % (_native.last_error() or "build failed"))
        self._lib = lib
        self._handle = lib.MXTStoragePoolCreate(max_cached_bytes)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and self._lib is not None:
            self._lib.MXTStoragePoolFree(handle)

    def alloc(self, size):
        """A raw aligned allocation as an int address (:meth:`release` it)."""
        ptr = self._lib.MXTStorageAlloc(self._handle, size)
        if not ptr:
            raise MemoryError("StoragePool.alloc(%d) failed" % size)
        return ptr

    def release(self, ptr, size):
        self._lib.MXTStorageRelease(self._handle, ptr, size)

    def empty(self, shape, dtype=np.float32):
        """A numpy array over pooled memory. The buffer returns to the pool
        when the array and every view of it (a ``torch.from_numpy`` tensor
        holds its array) are gone."""
        dtype = np.dtype(dtype)
        nelem = int(np.prod(shape))
        # at least one element, so a zero-sized array still maps a valid
        # buffer; count= keeps the logical length exact
        nbytes = max(nelem, 1) * dtype.itemsize
        ptr = self.alloc(nbytes)
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=nelem).reshape(shape)
        return _wrap(arr, _Guard(self, ptr, nbytes))

    def stats(self):
        vals = [ctypes.c_int64() for _ in range(4)]
        self._lib.MXTStoragePoolStats(self._handle,
                                      *[ctypes.byref(v) for v in vals])
        return {
            "live_bytes": vals[0].value, "cached_bytes": vals[1].value,
            "hits": vals[2].value, "misses": vals[3].value,
        }

    def drain(self):
        self._lib.MXTStoragePoolDrain(self._handle)


class _Guard:
    """Returns the buffer to the pool when the owning array is collected."""

    def __init__(self, pool, ptr, nbytes):
        self._pool, self._ptr, self._nbytes = pool, ptr, nbytes

    def __del__(self):
        self._pool.release(self._ptr, self._nbytes)


class _PooledNDArray(np.ndarray):
    """An ndarray that carries the pool's guard through its views."""

    def __array_finalize__(self, obj):
        if obj is not None:
            self._pool_guard = getattr(obj, "_pool_guard", None)


def _wrap(arr, guard):
    out = arr.view(_PooledNDArray)
    out._pool_guard = guard
    return out


_DEFAULT = None
_LOCK = threading.Lock()


def default_pool():
    """The process's pool, capped at ``MXNET_TPU_HOST_POOL_BYTES`` cached
    bytes."""
    global _DEFAULT
    if _DEFAULT is None:
        with _LOCK:
            if _DEFAULT is None:
                _DEFAULT = StoragePool(
                    config.get_nonneg_int("MXNET_TPU_HOST_POOL_BYTES"))
    return _DEFAULT
