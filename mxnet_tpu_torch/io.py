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

``PrefetchingIter`` runs source iterators on background threads;
``MNISTIter``, ``CSVIter`` and ``LibSVMIter`` read their files into an
``NDArrayIter``; ``ImageRecordIter``, ``ImageRecordUInt8Iter`` and
``ImageDetRecordIter`` read RecordIO image files through ``image``. All of
them give host batches, which the executor group (or a
``parallel.DeviceQueueIter``) copies to the card.
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import time
from collections import OrderedDict, namedtuple

import numpy as np

from .base import MXNetError
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


class _Failed:
    """A source iterator's exception, carried from a prefetch thread."""

    def __init__(self, exc):
        self.exc = exc


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators, one thread
    each, their batches concatenated (``rename_data``/``rename_label``
    rename their inputs). :meth:`close` (also a context manager) joins the
    threads; ``reset()`` works after ``StopIteration`` and restarts the
    epoch cleanly. An exception in a source iterator's ``next()`` is
    raised by the consumer's next ``next()``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self._closed = False
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as exc:  # raised on the consumer
                    self.next_batch[i] = _Failed(exc)
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i])
            for i in range(self.n_iter)
        ]
        for thread in self.prefetch_threads:
            thread.daemon = True
            thread.start()

    def close(self):
        """Join the prefetch threads and close the source iterators that
        support close(). Idempotent; the iterator is unusable after."""
        if self._closed:
            return
        self._closed = True
        self.started = False
        # a worker mid-fetch clears data_taken when its next() returns,
        # erasing a single set() — keep re-signalling until each thread
        # observes started=False. Bounded: a worker wedged inside the
        # source iterator's next() is a daemon and is abandoned.
        deadline = time.monotonic() + 5.0
        for e, thread in zip(self.data_taken, self.prefetch_threads):
            while thread.is_alive() and time.monotonic() < deadline:
                e.set()
                thread.join(timeout=0.05)
        for it in self.iters:
            inner_close = getattr(it, "close", None)
            if callable(inner_close):
                inner_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum(
            [
                [
                    DataDesc(r[x.name], x.shape, x.dtype)
                    if isinstance(x, DataDesc)
                    else DataDesc(r[x[0]], x[1])
                    for x in i.provide_data
                ]
                for r, i in zip(self.rename_data, self.iters)
            ],
            [],
        )

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum(
            [
                [
                    DataDesc(r[x.name], x.shape, x.dtype)
                    if isinstance(x, DataDesc)
                    else DataDesc(r[x[0]], x[1])
                    for x in i.provide_label
                ]
                for r, i in zip(self.rename_label, self.iters)
            ],
            [],
        )

    def reset(self):
        if self._closed:
            raise MXNetError("PrefetchingIter: iterator is closed")
        # after StopIteration data_ready is already set (next_batch is
        # None), so this wait returns immediately and the epoch restarts
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if self._closed:
            raise MXNetError("PrefetchingIter: iterator is closed")
        for e in self.data_ready:
            e.wait()
        for batch in self.next_batch:
            if isinstance(batch, _Failed):
                raise batch.exc
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, \
                    "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Different pad values in the iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label,
        )
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
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


class MNISTIter(DataIter):
    """MNIST reader: the idx files (optionally ``.gz``), shuffled once
    with ``seed``, batches from :class:`NDArrayIter` on the host."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_images(image)
        labels = self._read_labels(label)
        if shuffle:
            rng = np.random.RandomState(seed or 0)
            order = rng.permutation(len(imgs))
            imgs, labels = imgs[order], labels[order]
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.reshape(len(imgs), 1, 28, 28)
        self._iter = NDArrayIter(imgs, labels.astype(np.float32),
                                 batch_size=batch_size,
                                 last_batch_handle="discard")

    @staticmethod
    def _open(path):
        if path.endswith(".gz") or (not os.path.exists(path)
                                    and os.path.exists(path + ".gz")):
            p = path if path.endswith(".gz") else path + ".gz"
            return gzip.open(p, "rb")
        return open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("bad MNIST image magic %d" % magic)
            return np.frombuffer(f.read(num * rows * cols),
                                 dtype=np.uint8).reshape(num, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("bad MNIST label magic %d" % magic)
            return np.frombuffer(f.read(num), dtype=np.uint8)

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class CSVIter(DataIter):
    """CSV reader: rows reshaped to ``data_shape``, batches from
    :class:`NDArrayIter` on the host."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1 and tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._iter = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label",
        )

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


def ImageRecordIter(**kwargs):
    """RecordIO image pipeline over the recordio reader and the image
    module (``image.recordio_iter.ImageRecordIterImpl``)."""
    from .image.recordio_iter import ImageRecordIterImpl

    return ImageRecordIterImpl(**kwargs)


def ImageRecordUInt8Iter(**kwargs):
    """:func:`ImageRecordIter` giving uint8 images."""
    from .image.recordio_iter import ImageRecordIterImpl

    return ImageRecordIterImpl(dtype="uint8", **kwargs)


def ImageDetRecordIter(path_imgrec, data_shape=(3, 300, 300), batch_size=1,
                       path_imgidx=None, shuffle=False, mean_r=0.0, mean_g=0.0,
                       mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                       rand_crop_prob=0.0, rand_pad_prob=0.0,
                       rand_mirror_prob=0.0,
                       min_object_covered=0.1, min_eject_coverage=0.3,
                       max_attempts=50, pad_val=127, resize_mode="force",
                       label_pad_width=0, data_name="data", label_name="label",
                       **kwargs):
    """Detection RecordIO pipeline: recordio decode, bbox-aware augment,
    force-resize, padded (batch, max_obj, width) labels, with background
    prefetch (:class:`PrefetchingIter`)."""
    from .image.detection import ImageDetIter
    from .image.recordio_iter import mean_std_arrays

    if kwargs:
        raise MXNetError("ImageDetRecordIter: unknown parameters %r"
                         % sorted(kwargs))
    if resize_mode != "force":
        raise MXNetError("ImageDetRecordIter: only resize_mode='force' is "
                         "implemented (got %r)" % resize_mode)
    mean, std = mean_std_arrays(mean_r, mean_g, mean_b, std_r, std_g, std_b)
    inner = ImageDetIter(
        batch_size=batch_size, data_shape=tuple(data_shape),
        path_imgrec=path_imgrec, path_imgidx=path_imgidx, shuffle=shuffle,
        rand_crop=rand_crop_prob, rand_pad=rand_pad_prob,
        rand_mirror=rand_mirror_prob, mean=mean, std=std,
        min_object_covered=min_object_covered,
        min_eject_coverage=min_eject_coverage, max_attempts=max_attempts,
        pad_val=(pad_val,) * 3 if np.isscalar(pad_val) else tuple(pad_val),
        data_name=data_name, label_name=label_name,
    )
    if label_pad_width:
        width = inner.object_width
        # pad up only; reshape() rejects shrinking below the dataset extent
        objs = max(inner.max_objects, label_pad_width // width)
        inner.reshape(label_shape=(objs, width))
    return PrefetchingIter(inner)


class LibSVMIter(DataIter):
    """libsvm reader: ``label index:value ...`` lines into a dense batch,
    as the JAX package gives it."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        feat_dim = int(np.prod(data_shape))
        rows = []
        labels = []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(feat_dim, dtype=np.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = np.stack(rows).reshape((-1,) + tuple(data_shape))
        self._iter = NDArrayIter(data, np.asarray(labels, dtype=np.float32),
                                 batch_size=batch_size,
                                 last_batch_handle="discard",
                                 label_name="label")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()
