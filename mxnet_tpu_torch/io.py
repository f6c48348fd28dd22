"""Data iterators (counterpart of ``mxnet_tpu/io.py``): ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter`` and ``ResizeIter``.

``NDArrayIter`` keeps numpy inputs on the host (CPU NDArrays), as the
JAX package's iterators stage on the host: the executor group copies each
batch into the bound arrays on the card, one copy per input a batch.
Arrays already on a card stay there. Aligned batches are views of the
source arrays; the last batch wraps around (``pad``, ``roll_over``) or is
dropped (``discard``). ``shuffle`` permutes once, at construction, with
``rng`` (a ``numpy.random.RandomState`` or ``Generator``; default the
global numpy stream, as the JAX package draws it).

Not ported yet: ``PrefetchingIter`` and the record, image, CSV and
LibSVM iterators.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np

from .context import cpu
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray

_DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])


class DataDesc(_DataDesc):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One batch: lists of data and label arrays, and the pad count."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return "{}: data shapes: {} label shapes: {}".format(
            type(self).__name__, [d.shape for d in self.data],
            [lb.shape for lb in self.label] if self.label else None)


class DataIter:
    """Iterator base: ``next()`` builds a batch from ``getdata``,
    ``getlabel``, ``getpad`` and ``getindex`` while ``iter_next()``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, which restarts when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Inputs as a list of (name, NDArray); numpy goes to a host array."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must be given")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([("_%d_%s" % (i, default_name), d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            if not isinstance(v, (np.ndarray, list, tuple)):
                raise TypeError("Invalid type '%s' for %s" % (type(v), k))
            v = nd.array(v, ctx=cpu())
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, with pad, discard or roll_over for the
    last batch and an optional shuffle."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", rng=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or "
                             "roll_over, got %r" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            (rng if rng is not None else np.random).shuffle(self.idx)
            order = nd.array(self.idx, ctx=cpu(), dtype="int64")
            self.data = [(k, v.take(order.as_in_context(v.context)))
                         for k, v in self.data]
            self.label = [(k, v.take(order.as_in_context(v.context)))
                          for k, v in self.label]
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, source):
        if self.cursor >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [v[self.cursor:end] for _k, v in source]
        pad = end - self.num_data
        return [nd.concatenate([v[self.cursor:self.num_data], v[:pad]])
                for _k, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
