"""Library locations and feature flags (``mx.libinfo``; counterpart of
``mxnet_tpu/libinfo.py``). The port's native libraries are its
hand-written CUDA kernels, built at first use into
``mxnet_tpu_torch/_build`` (``kernels/_build.py``); ``features()`` has the
JAX package's keys with the port's values."""
from __future__ import annotations

import os

__version__ = "0.1.0"


def find_lib_path():
    """The built kernel libraries (``_build/lib<name>-<hash>.so``), sorted;
    empty before the first build (the kernels build from source at first
    use, so none is required)."""
    from .kernels._build import BUILD_DIR

    return sorted(str(p) for p in BUILD_DIR.glob("lib*.so"))


def find_include_path():
    """The repository's C ABI headers (``src/``), or "" without them."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    return src if os.path.isdir(src) else ""


def features():
    """Build and runtime flags: ``NATIVE_RUNTIME`` (the JAX package's C++
    host runtime: not used by the port), ``BACKEND`` (``cuda`` with a
    card, else ``cpu``), ``DEVICES`` (the CUDA devices, else the one CPU),
    ``PALLAS`` (no: the kernels are CUDA C++) and ``DIST``
    (``torch.distributed``)."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "NATIVE_RUNTIME": False,
        "BACKEND": "cuda" if cuda else "cpu",
        "DEVICES": torch.cuda.device_count() if cuda else 1,
        "PALLAS": False,
        "DIST": torch.distributed.is_available(),
    }
