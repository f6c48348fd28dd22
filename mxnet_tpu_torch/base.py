"""Base error type, auto-naming and dtype names of the PyTorch port
(counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import threading

import numpy as np
import torch


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: python/mxnet/base.py MXNetError)."""


_NAME_LOCK = threading.Lock()
_NAME_COUNTS = {}


def auto_name(prefix: str) -> str:
    """Per-prefix sequential names, ``convolution0``, ``convolution1``
    (NameManager parity; the port has no name scopes)."""
    prefix = prefix.lower()
    with _NAME_LOCK:
        idx = _NAME_COUNTS.get(prefix, 0)
        _NAME_COUNTS[prefix] = idx + 1
    return "%s%d" % (prefix, idx)


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
