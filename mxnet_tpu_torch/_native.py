"""Build and load the native host runtime and the C predict library
(counterpart of ``mxnet_tpu/_native.py``).

The runtime (the dependency engine, the storage pool and RecordIO) is
compiled from the repository's ``src/`` (``common.cc``, ``engine.cc``,
``storage.cc``, ``recordio.cc``) by ``g++`` called directly, with the
flags of ``src/Makefile``, into
``mxnet_tpu_torch/_build/libmxtpu_runtime-<hash>.so``, and loaded with
:mod:`ctypes`. The C predict ABI (``src/c_predict_api.h``) builds from the
port's own shim, ``native/c_predict.cc``, into
``libmxtpu_predict-<hash>.so`` beside it. Each hash covers the sources,
the headers and the flags, so an edited source is never served a stale
library. A build writes a per-process temporary file and renames it into
place, so processes building at once never load a partial library.

Nothing builds at import: the runtime builds at the first
:func:`get_lib`. ``MXNET_TPU_NO_NATIVE=1`` forces the Python paths, and a
failed build does too (:func:`get_lib` returns None; :func:`last_error`
says why).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
import time

from .base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(ROOT, "src")
SHIM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
RUNTIME_SOURCES = ("common.cc", "engine.cc", "storage.cc", "recordio.cc")
RUNTIME_HEADERS = ("mxtpu_runtime.h",)
# src/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-fvisibility=hidden")
LDFLAGS = ("-shared", "-pthread")
_STALE_TMP_S = 600   # a temporary file this old was left by a dead build

_LIB = None          # None: not tried; False: unavailable; else the CDLL
_LOCK = threading.Lock()
_BUILD_ERROR = ""


def _hashed_path(name, inputs, flags, build_dir):
    digest = hashlib.sha256()
    for path in inputs:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(build_dir or BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:16]))


def _compile(out, sources, cflags, ldflags):
    """Compile ``sources`` (one g++ each, all started together), link them
    into a per-process temporary file, then rename it to ``out``. Sweeps
    the temporary files of builds that died (older than 10 minutes: a live
    build's file is never taken from under its rename)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for stale in glob.glob(out + ".tmp.*"):
        try:
            if time.time() - os.path.getmtime(stale) > _STALE_TMP_S:
                os.remove(stale)
        except OSError:
            pass
    tmp = "%s.tmp.%d" % (out, os.getpid())
    cxx = _cxx()
    with tempfile.TemporaryDirectory() as objdir:
        objs = [os.path.join(objdir, "%d.o" % i)
                for i in range(len(sources))]
        jobs = [subprocess.Popen([cxx, *cflags, "-c", src, "-o", obj],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
        try:
            logs = [job.communicate(timeout=600)[0] for job in jobs]
        finally:
            for job in jobs:
                if job.poll() is None:
                    job.kill()
                    job.wait()
        for src, job, log in zip(sources, jobs, logs):
            if job.returncode != 0:
                raise MXNetError("g++ failed for %s (rc %d):\n%s"
                                 % (src, job.returncode, log[-4000:]))
        try:
            r = subprocess.run([cxx, *objs, *ldflags, "-o", tmp],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise MXNetError("linking %s failed (rc %d):\n%s"
                                 % (out, r.returncode, r.stderr[-4000:]))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _cxx():
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise MXNetError("g++ not found: the native runtime builds from "
                         "src/ at first use (set CXX or put g++ on PATH)")
    return cxx


def _lib_path(build_dir=None):
    """The runtime library's path for the current sources and flags."""
    return _hashed_path(
        "mxtpu_runtime",
        [os.path.join(SRC_DIR, f) for f in RUNTIME_SOURCES + RUNTIME_HEADERS],
        CXXFLAGS + LDFLAGS, build_dir)


def build(build_dir=None):
    """Compile the runtime unless its library exists; returns its path.
    Raises :class:`MXNetError` when ``src/`` or ``g++`` is missing or the
    compile fails."""
    if not os.path.isdir(SRC_DIR):
        raise MXNetError("no sources at %s: the native runtime builds from "
                         "the repository's src/" % SRC_DIR)
    out = _lib_path(build_dir)
    if os.path.exists(out):
        return out
    return _compile(out, [os.path.join(SRC_DIR, f) for f in RUNTIME_SOURCES],
                    CXXFLAGS, LDFLAGS)


def _python_flags():
    """The include flag, then the link flags, that embed this interpreter,
    from ``sysconfig``. Without a shared libpython the library is left to
    find the interpreter's symbols in the process that loads it (a ctypes
    consumer), and a standalone C program cannot link it."""
    flags = ["-I" + sysconfig.get_paths()["include"]]
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR")
        name = sysconfig.get_config_var("LDLIBRARY")   # libpython3.12.so
        flags += ["-L" + libdir, "-l" + name[3:].split(".so")[0],
                  "-Wl,-rpath," + libdir]
    return flags + ["-ldl"]


def predict_lib_path(build_dir=None):
    """The C predict library's path for the current sources and flags."""
    return _hashed_path(
        "mxtpu_predict",
        [os.path.join(SHIM_DIR, "c_predict.cc"),
         os.path.join(SHIM_DIR, "embed_common.h"),
         os.path.join(SRC_DIR, "c_predict_api.h")],
        CXXFLAGS + LDFLAGS + tuple(_python_flags()), build_dir)


def build_predict(build_dir=None):
    """Compile the C predict library (``src/c_predict_api.h`` served by
    ``native/c_predict.cc``, which embeds CPython and calls
    :mod:`mxnet_tpu_torch.c_predict`) unless it exists; returns its path.
    Raises :class:`MXNetError` when the compile fails (no ``Python.h``, no
    ``g++``)."""
    out = predict_lib_path(build_dir)
    if os.path.exists(out):
        return out
    include, *link = _python_flags()
    return _compile(out, [os.path.join(SHIM_DIR, "c_predict.cc")],
                    CXXFLAGS + ("-I" + SRC_DIR, include),
                    LDFLAGS + tuple(link))


def _declare(lib):
    c = ctypes.c_void_p
    lib.MXTGetLastError.restype = ctypes.c_char_p
    lib.MXTEngineCreate.restype = c
    lib.MXTEngineCreate.argtypes = [ctypes.c_int]
    lib.MXTEngineFree.argtypes = [c]
    lib.MXTEngineNewVar.restype = ctypes.c_int64
    lib.MXTEngineNewVar.argtypes = [c]
    lib.MXTEnginePush.restype = ctypes.c_int
    lib.MXTEnginePush.argtypes = [
        c, ENGINE_FN, c,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
    lib.MXTEngineWaitForVar.restype = ctypes.c_int
    lib.MXTEngineWaitForVar.argtypes = [c, ctypes.c_int64]
    lib.MXTEngineWaitAll.restype = ctypes.c_int
    lib.MXTEngineWaitAll.argtypes = [c]
    lib.MXTEngineStats.argtypes = [c, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]

    lib.MXTStoragePoolCreate.restype = c
    lib.MXTStoragePoolCreate.argtypes = [ctypes.c_size_t]
    lib.MXTStoragePoolFree.argtypes = [c]
    lib.MXTStorageAlloc.restype = c
    lib.MXTStorageAlloc.argtypes = [c, ctypes.c_size_t]
    lib.MXTStorageRelease.argtypes = [c, c, ctypes.c_size_t]
    lib.MXTStoragePoolStats.argtypes = \
        [c] + [ctypes.POINTER(ctypes.c_int64)] * 4
    lib.MXTStoragePoolDrain.argtypes = [c]

    lib.MXTRecordIOWriterCreate.restype = c
    lib.MXTRecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordIOWriterWrite.restype = ctypes.c_int
    lib.MXTRecordIOWriterWrite.argtypes = [c, ctypes.c_char_p,
                                           ctypes.c_size_t]
    lib.MXTRecordIOWriterTell.restype = ctypes.c_int64
    lib.MXTRecordIOWriterTell.argtypes = [c]
    lib.MXTRecordIOWriterClose.restype = ctypes.c_int
    lib.MXTRecordIOWriterClose.argtypes = [c]
    lib.MXTRecordIOReaderCreate.restype = c
    lib.MXTRecordIOReaderCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordIOReaderNext.restype = ctypes.c_int
    lib.MXTRecordIOReaderNext.argtypes = [
        c, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t)]
    lib.MXTRecordIOReaderSeek.restype = ctypes.c_int
    lib.MXTRecordIOReaderSeek.argtypes = [c, ctypes.c_int64]
    lib.MXTRecordIOReaderTell.restype = ctypes.c_int64
    lib.MXTRecordIOReaderTell.argtypes = [c]
    lib.MXTRecordIOReaderClose.restype = ctypes.c_int
    lib.MXTRecordIOReaderClose.argtypes = [c]
    return lib


ENGINE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def get_lib():
    """The loaded runtime library, or None (``MXNET_TPU_NO_NATIVE=1``, or
    the build failed: :func:`last_error` says why). Built at the first
    call."""
    global _LIB, _BUILD_ERROR
    if _LIB is not None:
        return _LIB or None
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        if os.environ.get("MXNET_TPU_NO_NATIVE", "0") == "1":
            _LIB = False
            return None
        try:
            _LIB = _declare(ctypes.CDLL(build()))
        except (OSError, MXNetError, subprocess.TimeoutExpired) as e:
            _BUILD_ERROR = str(e)
            _LIB = False
    return _LIB or None


def last_error():
    """The runtime's last error message (thread-local), or why the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return _BUILD_ERROR
    return (lib.MXTGetLastError() or b"").decode()
