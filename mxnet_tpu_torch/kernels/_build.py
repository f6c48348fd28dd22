"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``mxnet_tpu_torch/_build/lib<name>-<hash>.so``
at first use, then loaded with :mod:`ctypes`. The file name carries a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is never served a stale library. Nothing here runs at import time: the CPU tests import every module,
and a machine without ``nvcc`` must still be able to import them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "fused_conv_fwd",
           "fused_conv_wgrad", "fused_conv_dgrad")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                     "the CUDA kernels are built from source at first use")


def lib_path(name):
    """The library of ``csrc/<name>.cu``; its hash covers the source, every
    shared header of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / ("%s.cu" % name)).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_all(names=SOURCES):
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is
    missing, one ``nvcc`` each, all started together; returns ``{name:
    compiler output}`` (``-Xptxas=-v`` prints registers, shared memory and
    spills per kernel). A failed compile raises :class:`MXNetError`."""
    logs, jobs = {}, {}
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                logs[name] = "cached: %s" % out
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(".so.tmp%d" % os.getpid())
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / ("%s.cu" % name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append("nvcc failed for %s (rc %d):\n%s"
                              % (name, proc.returncode, logs[name]))
            else:
                os.replace(tmp, out)
        if failed:
            raise MXNetError("\n".join(failed))
    finally:
        for proc, tmp, _out in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return logs


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, built if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


_COUNT_LOCK = threading.Lock()


def count(fn, attr="launches"):
    """Add one to ``fn.<attr>``, a wrapper's launch count, under a lock:
    the replicas of a one-process mesh launch from threads of their own,
    and no count may be lost."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
