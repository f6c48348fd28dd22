"""ImageRecordIter implementation backing ``mx.io.ImageRecordIter``
(counterpart of ``mxnet_tpu/image/recordio_iter.py``). Two tiers:

- fast path (the common training config — resize / rand_crop /
  rand_mirror / mean / std): raw records are read serially, then
  ``preprocess_threads`` pool workers decode and augment each record
  straight into the preallocated batch buffer in numpy; PIL's JPEG
  decoder drops the GIL, so decode scales with cores. Pillow is imported
  only where a decode or a resize needs it, so ``.npy`` records without
  ``resize`` run where Pillow is missing.
- general path: the composable ImageIter augmenters.

Both are wrapped with background-thread prefetch (``PrefetchingIter``) so
decode overlaps the step; batches stay on the host.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter, PrefetchingIter
from .image import ImageIter, _host, imdecode_bytes


class _FastRecordIter(DataIter):
    """Thread-pool decode+augment of a packed RecordIO image dataset."""

    def __init__(self, path_imgrec, path_imgidx, data_shape, batch_size,
                 label_width, shuffle, resize, rand_crop, rand_mirror,
                 mean, std, preprocess_threads, data_name, label_name,
                 seed=0, part_index=0, num_parts=1):
        super().__init__(batch_size)
        from .. import recordio

        if not path_imgidx:
            raise MXNetError("fast record iter requires path_imgidx")
        self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
        from .image import partition_rng_and_shard

        mixed_seed, self._keys = partition_rng_and_shard(
            seed, part_index, num_parts, self._rec.keys)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        ch = tuple(data_shape)[0]
        self.mean = None if mean is None else \
            np.resize(mean.astype(np.float32), ch)
        self.std = None if std is None else \
            np.resize(std.astype(np.float32), ch)
        self._rng = np.random.RandomState(mixed_seed)
        self._pool = (ThreadPoolExecutor(preprocess_threads)
                      if preprocess_threads > 1 else None)
        self.data_name = data_name
        self.label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self._order = list(self._keys)
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._cur = 0

    def _process(self, raw, out, i, crop_xy, mirror):
        """decode → resize → crop → mirror → normalize, all numpy
        (runs on a pool thread; PIL decode releases the GIL)."""
        from .. import recordio

        header, img_bytes = recordio.unpack(raw)
        # imdecode_bytes handles JPEG/PNG and the repo's .npy payloads
        # alike (same decode support as the general path)
        arr = np.asarray(imdecode_bytes(img_bytes), dtype=np.uint8)
        _, th, tw = self.data_shape
        if self.resize:
            from PIL import Image

            h, w = arr.shape[:2]
            if w < h:
                size = (self.resize, int(h * self.resize / w))
            else:
                size = (int(w * self.resize / h), self.resize)
            arr = np.asarray(Image.fromarray(arr).resize(size, Image.BILINEAR),
                             dtype=np.uint8)
        hh, ww = arr.shape[:2]
        if hh < th or ww < tw:
            from PIL import Image

            im2 = Image.fromarray(arr).resize((max(tw, ww), max(th, hh)),
                                              Image.BILINEAR)
            arr = np.asarray(im2, dtype=np.uint8)
            hh, ww = arr.shape[:2]
        y0 = int(crop_xy[0] * (hh - th)) if self.rand_crop else (hh - th) // 2
        x0 = int(crop_xy[1] * (ww - tw)) if self.rand_crop else (ww - tw) // 2
        arr = arr[y0:y0 + th, x0:x0 + tw]
        if mirror:
            arr = arr[:, ::-1]
        f = arr.astype(np.float32)
        # grayscale/odd-channel decodes: coerce to data_shape's channel
        # count instead of raising in the transpose below
        ch = self.data_shape[0]
        if f.ndim == 2:
            f = f[:, :, None]
        if f.shape[2] != ch:
            if ch == 1:
                f = f.mean(axis=2, keepdims=True)
            elif f.shape[2] < ch:
                reps = -(-ch // f.shape[2])  # tile up then trim
                f = np.tile(f, (1, 1, reps))[:, :, :ch]
            else:
                f = f[:, :, :ch]
        if self.mean is not None:
            f -= self.mean
        if self.std is not None:
            f /= self.std
        out[i] = f.transpose(2, 0, 1)
        label = header.label
        return (float(label) if np.isscalar(label) or np.ndim(label) == 0
                else np.asarray(label, np.float32)[:self.label_width])

    def next(self):
        if self._cur >= len(self._order):
            raise StopIteration
        idx = self._order[self._cur:self._cur + self.batch_size]
        self._cur += self.batch_size
        pad = self.batch_size - len(idx)
        if pad:
            idx = idx + self._order[:pad]
        raws = [self._rec.read_idx(k) for k in idx]   # serial IO: cheap
        out = np.zeros((self.batch_size,) + self.data_shape, np.float32)
        crops = self._rng.rand(self.batch_size, 2)
        mirrors = (self._rng.rand(self.batch_size) < 0.5
                   if self.rand_mirror else np.zeros(self.batch_size, bool))
        if self._pool is not None:
            labels = list(self._pool.map(
                self._process, raws, [out] * len(raws), range(len(raws)),
                crops, mirrors))
        else:
            labels = [self._process(r, out, i, crops[i], mirrors[i])
                      for i, r in enumerate(raws)]
        if self.label_width == 1:
            blabel = np.asarray([l if np.isscalar(l) else l[0]
                                 for l in labels], np.float32)
        else:
            blabel = np.stack([np.resize(np.asarray(l, np.float32),
                                         self.label_width) for l in labels])
        return DataBatch(data=[_host(out)], label=[_host(blabel)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def mean_std_arrays(mean_r, mean_g, mean_b, std_r, std_g, std_b):
    """(mean_r,g,b)/(std_r,g,b) scalars → optional np arrays (shared by the
    classification and detection record iterators)."""
    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b])
    std = None
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = np.array([std_r, std_g, std_b])
    return mean, std


class ImageRecordIterImpl(DataIter):
    """``ImageRecordIter``: the fast path for the common configuration
    (an index file, no other options), else the general path, behind a
    ``PrefetchingIter``."""

    def __init__(self, path_imgrec=None, data_shape=(3, 224, 224),
                 batch_size=1, label_width=1, shuffle=False, mean_r=0.0,
                 mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 rand_crop=False, rand_mirror=False, resize=0,
                 dtype="float32", preprocess_threads=4, prefetch_buffer=4,
                 path_imgidx=None, data_name="data",
                 label_name="softmax_label", seed=0, part_index=0,
                 num_parts=1, **kwargs):
        super().__init__(batch_size)
        mean, std = mean_std_arrays(mean_r, mean_g, mean_b, std_r, std_g,
                                    std_b)
        if path_imgidx and not kwargs:
            # common training config: the threaded numpy fast path
            inner = _FastRecordIter(
                path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                data_shape=tuple(data_shape), batch_size=batch_size,
                label_width=label_width, shuffle=shuffle, resize=resize,
                rand_crop=rand_crop, rand_mirror=rand_mirror,
                mean=mean, std=std, preprocess_threads=preprocess_threads,
                data_name=data_name, label_name=label_name,
                seed=seed, part_index=part_index, num_parts=num_parts)
        else:
            inner = ImageIter(
                batch_size=batch_size, data_shape=tuple(data_shape),
                label_width=label_width, path_imgrec=path_imgrec,
                path_imgidx=path_imgidx, shuffle=shuffle,
                rand_crop=rand_crop, rand_mirror=rand_mirror, resize=resize,
                mean=mean, std=std, data_name=data_name, label_name=label_name,
                seed=seed, part_index=part_index, num_parts=num_parts,
                **kwargs,
            )
        self._iter = PrefetchingIter(inner)

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
