"""Base error type, auto-naming and dtype names of the PyTorch port
(counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import re
import threading

import numpy as np
import torch


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: python/mxnet/base.py MXNetError)."""


_NAME_LOCK = threading.Lock()
_NAME_COUNTS = {}


def auto_name(prefix: str) -> str:
    """Per-prefix sequential names, ``convolution0``, ``convolution1``:
    from the innermost active ``name.NameManager`` if there is one, else
    from the package's global counter."""
    from .name import current

    prefix = prefix.lower()
    manager = current()
    if manager is not None:
        return manager.get(None, prefix)
    with _NAME_LOCK:
        idx = _NAME_COUNTS.get(prefix, 0)
        _NAME_COUNTS[prefix] = idx + 1
    return "%s%d" % (prefix, idx)


def reset_naming():
    """Restart the global per-prefix name counters."""
    with _NAME_LOCK:
        _NAME_COUNTS.clear()


_PYTHONIC = re.compile(r"[^0-9a-zA-Z_]")


def sanitize_name(name: str) -> str:
    return _PYTHONIC.sub("_", name)


def check_call(ret):
    """The JAX package's shim for its C-API surface: there is no C ABI,
    errors are Python exceptions."""
    return ret


def classproperty(func):
    class _Desc:
        def __get__(self, _obj, objtype=None):
            return func(objtype)

    return _Desc()


_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def dtype_name(dtype) -> str:
    """Canonical string name of a dtype given as a string, a numpy dtype or
    a torch dtype."""
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError("unknown dtype %r" % (dtype,))
    return name


def dtype_torch(dtype) -> torch.dtype:
    """The torch dtype of a dtype spec (``None`` is float32). The port's
    counterpart of ``dtype_np``: its arrays are torch tensors, and numpy
    has no bfloat16."""
    return torch.float32 if dtype is None else _DTYPES[dtype_name(dtype)]
