"""Library locations and feature flags (``mx.libinfo``; counterpart of
``mxnet_tpu/libinfo.py``). The port's native libraries are the host
runtime (``_native.py``: ``src/``'s engine, storage pool and RecordIO,
built with g++) and its hand-written CUDA kernels (``kernels/_build.py``),
both built at first use into ``mxnet_tpu_torch/_build``; ``features()``
has the JAX package's keys with the port's values."""
from __future__ import annotations

import os

__version__ = "0.1.0"


def find_lib_path():
    """The host runtime's library first (built here if it is missing; left
    out under ``MXNET_TPU_NO_NATIVE=1`` or when it cannot build), then the
    other built libraries of ``_build/`` (``lib<name>-<hash>.so``), sorted:
    the kernels build from source at first use, so none is required."""
    from . import _native
    from .kernels._build import BUILD_DIR

    runtime = [_native._lib_path()] if _native.get_lib() is not None else []
    return runtime + sorted(str(p) for p in BUILD_DIR.glob("lib*.so")
                            if str(p) not in runtime)


def find_include_path():
    """The repository's C ABI headers (``src/``), or "" without them."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    return src if os.path.isdir(src) else ""


def features():
    """Build and runtime flags: ``NATIVE_RUNTIME`` (the host runtime's
    library is loaded), ``BACKEND`` (``cuda`` with a
    card, else ``cpu``), ``DEVICES`` (the CUDA devices, else the one CPU),
    ``PALLAS`` (no: the kernels are CUDA C++) and ``DIST``
    (``torch.distributed``)."""
    import torch

    from . import _native

    cuda = torch.cuda.is_available()
    return {
        "NATIVE_RUNTIME": _native.get_lib() is not None,
        "BACKEND": "cuda" if cuda else "cpu",
        "DEVICES": torch.cuda.device_count() if cuda else 1,
        "PALLAS": False,
        "DIST": torch.distributed.is_available(),
    }
