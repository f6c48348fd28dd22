"""Gluon's utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``;
``download`` raises, as nothing is fetched over a network."""
from __future__ import annotations

import hashlib

import numpy as np

from ..base import MXNetError
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``, the last one
    taking the remainder when ``even_split`` is False."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    bounds = [(i * step, (i + 1) * step if i < num_slice - 1 else size)
              for i in range(num_slice)]
    if batch_axis == 0:
        return [data[begin:end] for begin, end in bounds]
    return [nd.invoke("slice_axis", [data],
                      {"axis": batch_axis, "begin": begin, "end": end})
            for begin, end in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split over ``ctx_list``, each slice on its context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale the arrays in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before."""
    assert len(arrays) > 0
    total_norm = 0.0
    for arr in arrays:
        norm = arr.norm().asscalar()
        total_norm += norm * norm
    total_norm = np.sqrt(total_norm)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    raise MXNetError("download: nothing is fetched over a network; place "
                     "files locally and pass a path instead")
