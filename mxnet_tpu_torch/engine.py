"""The host dependency engine (counterpart of ``mxnet_tpu/engine.py``).

MXNet's ``Engine`` API with its var semantics: concurrent readers,
exclusive writers, program order. torch's streams order the work on the
card; this engine orders host work (prefetch, checkpoint IO, callbacks)
and launches nothing on the card itself. A pushed function may run torch
code.

Engines (``MXNET_ENGINE_TYPE``):

- ``ThreadedEngine`` (the default; ``ThreadedEnginePerDevice`` is an
  alias): the native scheduler of ``src/engine.cc``, built by
  :mod:`._native`, on ``MXNET_CPU_WORKER_NTHREADS`` worker threads.
- ``NaiveEngine``: runs each function when it is pushed.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading

from . import _native, config
from .base import MXNetError

__all__ = ["Engine", "NaiveEngine", "ThreadedEngine", "get", "create",
           "new_var", "push", "wait_for_var", "wait_for_all",
           "set_bulk_size", "bulk"]


class NaiveEngine:
    """Runs each function when it is pushed, which respects every
    dependency."""

    def __init__(self, num_threads=None):
        self._pushed = 0

    def new_var(self):
        return object()

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        self._pushed += 1
        fn()

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass

    def stats(self):
        return {"pushed": self._pushed, "executed": self._pushed}


class ThreadedEngine:
    """The native dependency engine through ctypes. A var is an int
    handle of this engine; a pushed function runs on a worker thread once
    every var it reads or writes grants it."""

    def __init__(self, num_threads=None):
        lib = _native.get_lib()
        if lib is None:
            raise MXNetError(
                "native runtime unavailable (%s); use NaiveEngine or unset "
                "MXNET_TPU_NO_NATIVE"
                % (_native.last_error() or "build failed"))
        self._lib = lib
        if num_threads is None:
            num_threads = config.get_positive_int("MXNET_CPU_WORKER_NTHREADS")
        self._handle = lib.MXTEngineCreate(num_threads)
        self._cb_lock = threading.Lock()
        self._callbacks = {}
        self._next_cb = 1  # keys start at 1: c_void_p(0) arrives as None

        def trampoline(arg):
            key = int(arg)
            with self._cb_lock:
                fn = self._callbacks.pop(key)
            fn()

        # kept on the engine: the native side calls it until the engine goes
        self._trampoline = _native.ENGINE_FN(trampoline)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and self._lib is not None:
            self._lib.MXTEngineFree(handle)

    def new_var(self):
        return self._lib.MXTEngineNewVar(self._handle)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        with self._cb_lock:
            key = self._next_cb
            self._next_cb += 1
            self._callbacks[key] = fn
        cv = (ctypes.c_int64 * max(len(const_vars), 1))(*const_vars)
        mv = (ctypes.c_int64 * max(len(mutable_vars), 1))(*mutable_vars)
        rc = self._lib.MXTEnginePush(
            self._handle, self._trampoline, ctypes.c_void_p(key),
            cv, len(const_vars), mv, len(mutable_vars), priority)
        if rc != 0:
            with self._cb_lock:
                self._callbacks.pop(key, None)
            raise MXNetError("engine push failed: %s" % _native.last_error())

    def wait_for_var(self, var):
        if self._lib.MXTEngineWaitForVar(self._handle, var) != 0:
            raise MXNetError("wait_for_var failed: %s" % _native.last_error())

    def wait_for_all(self):
        self._lib.MXTEngineWaitAll(self._handle)

    def stats(self):
        pushed = ctypes.c_int64()
        executed = ctypes.c_int64()
        self._lib.MXTEngineStats(self._handle, ctypes.byref(pushed),
                                 ctypes.byref(executed))
        return {"pushed": pushed.value, "executed": executed.value}


Engine = ThreadedEngine

_ENGINE = None
_ENGINE_LOCK = threading.Lock()


def create(kind=None, num_threads=None):
    """A new engine of ``kind`` (default ``MXNET_ENGINE_TYPE``). A
    ``ThreadedEngine`` whose native runtime is unavailable falls back to
    ``NaiveEngine`` with a warning, silently under
    ``MXNET_TPU_NO_NATIVE=1``."""
    kind = kind or os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine")
    if kind in ("ThreadedEngine", "ThreadedEnginePerDevice"):
        try:
            return ThreadedEngine(num_threads)
        except MXNetError as e:
            # a broken native build must be loud, not a silent slowdown
            # (opting out with MXNET_TPU_NO_NATIVE=1 is deliberate: quiet)
            if os.environ.get("MXNET_TPU_NO_NATIVE", "0") != "1":
                logging.getLogger("mxnet_tpu_torch").warning(
                    "native ThreadedEngine unavailable (%s); falling back "
                    "to NaiveEngine: the port builds src/ with g++ into "
                    "mxnet_tpu_torch/_build at first use, or set "
                    "MXNET_TPU_NO_NATIVE=1 to opt out explicitly", e)
            return NaiveEngine(num_threads)
    if kind == "NaiveEngine":
        return NaiveEngine(num_threads)
    raise MXNetError("unknown engine type %r" % kind)


def get():
    """The process's engine, made by :func:`create` at the first call."""
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = create()
    return _ENGINE


def new_var():
    return get().new_var()


def push(fn, const_vars=(), mutable_vars=(), priority=0):
    get().push(fn, const_vars, mutable_vars, priority)


def wait_for_var(var):
    get().wait_for_var(var)


def wait_for_all():
    get().wait_for_all()


_BULK_SIZE = 0


def set_bulk_size(size):
    """MXNet's ``engine.set_bulk_size``: records the value and returns the
    previous one. The port runs torch ops eagerly and has no bulk
    segments, so nothing reads it."""
    global _BULK_SIZE
    prev, _BULK_SIZE = _BULK_SIZE, int(size)
    return prev


class bulk:
    """``with bulk(size):`` sets the bulk size for the block (MXNet's
    ``engine.bulk``)."""

    def __init__(self, size):
        self.size = size
        self._old = None

    def __enter__(self):
        self._old = set_bulk_size(self.size)

    def __exit__(self, *exc):
        set_bulk_size(self._old)
