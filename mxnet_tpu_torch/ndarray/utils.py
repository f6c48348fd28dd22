"""NDArray files (counterpart of ``mxnet_tpu/ndarray/utils.py``).

The JAX package's format, read and written here byte for byte: one
``numpy.savez`` archive (``.npz``, no pickles) holding a dict's arrays by
name, or a list's as ``__mx_list_0``, ``__mx_list_1``, ... . bfloat16 is
stored as the JAX package stores it: numpy writes ``ml_dtypes.bfloat16``
as the raw 2-byte void type ``<V2``, so a ``<V2`` entry is read back as
bfloat16 bits. Files are read with ``allow_pickle=False``.
"""
from __future__ import annotations

import zipfile

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from .ndarray import NDArray, array

_LIST_PREFIX = "__mx_list_%d"


def _to_numpy(v):
    """The array's numpy value, bfloat16 as its raw 2-byte values."""
    t = v.tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).numpy()).view("V2")
    return t.numpy()


def _savez(f, payload):
    """``numpy.savez`` of ``payload``, with each bfloat16 entry's header
    saying ``<V2`` as numpy writes ``ml_dtypes.bfloat16`` (a plain
    2-byte void would say ``|V2``)."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as out:
                if arr.dtype != np.dtype("V2"):
                    np.lib.format.write_array(out, arr, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(out, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
                out.write(arr.tobytes())


def save(fname, data):
    """Save an NDArray, a list of them or a dict of str -> NDArray."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        if not all(isinstance(v, NDArray) for v in data.values()):
            raise MXNetError("save: values must be NDArrays")
        payload = {k: _to_numpy(v) for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        payload = {(_LIST_PREFIX % i): _to_numpy(v)
                   for i, v in enumerate(data)}
    else:
        raise MXNetError("save: data must be NDArray, list, or dict")
    with open(fname, "wb") as f:
        _savez(f, payload)


def _from_numpy(a, ctx):
    if a.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return NDArray(t.view(torch.bfloat16).to(ctx.torch_device()), ctx)
    return array(a, ctx=ctx, dtype=a.dtype)


def load(fname, ctx=None):
    """Load what :func:`save` (of either package) wrote: a list or a dict
    of NDArrays on ``ctx`` (default: ``current_context()``, as
    :func:`array`)."""
    ctx = ctx or current_context()
    with np.load(fname, allow_pickle=False) as npz:
        keys = list(npz.keys())
        if keys and all(k.startswith("__mx_list_") for k in keys):
            return [_from_numpy(npz[_LIST_PREFIX % i], ctx)
                    for i in range(len(keys))]
        return {k: _from_numpy(npz[k], ctx) for k in keys}
