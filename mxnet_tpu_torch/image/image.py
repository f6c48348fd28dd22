"""Image decode and augment pipeline (counterpart of
``mxnet_tpu/image/image.py``).

Decode: Pillow where it is installed and the payload needs it (it is
imported then, not at module import), raw-numpy ``.npy`` payloads without
it. Resize and crop run in numpy on the host, resize as the JAX package's
``jax.image.resize`` computes it (a separable weight matrix per spatial
dim: a triangle kernel widened by the downscale factor, normalized;
nearest takes ``floor((i + 0.5) * in / out)``). Every NDArray here lives
on the host (``cpu()``), as the JAX package's iterators stage on the
host; the executor group or a ``DeviceQueueIter`` places batches on the
card.
"""
from __future__ import annotations

import io as _io
import os
import random

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray


def _pil_image():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _host(arr, dtype=None):
    """A host NDArray holding a copy of ``arr`` (numpy)."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:      # a decoded image's read-only buffer
        arr = arr.copy()
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def partition_rng_and_shard(seed, part_index, num_parts, keys):
    """Shared DP-sharding contract for the image iterators: validate the
    partition, derive a per-worker RNG seed (partition mixed in so
    data-parallel workers diverge from one base seed), and shard the
    record keys worker k of N -> every Nth record."""
    if not 0 <= part_index < num_parts:
        raise MXNetError("part_index %d out of range for num_parts %d"
                         % (part_index, num_parts))
    mixed = (int(seed) * 1000003 + part_index * 8191) % (2 ** 31 - 1)
    return mixed, list(keys)[part_index::num_parts]


def imdecode_bytes(buf, iscolor=1):
    """Decode encoded image bytes to HWC uint8 numpy array."""
    if isinstance(buf, memoryview):
        buf = bytes(buf)
    if buf[:6] == b"\x93NUMPY":
        return np.load(_io.BytesIO(buf), allow_pickle=False)
    image = _pil_image()
    if image is None:
        raise MXNetError("image decode requires Pillow or .npy payloads")
    img = image.open(_io.BytesIO(buf))
    img = img.convert("RGB") if iscolor else img.convert("L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def imencode_bytes(img, img_fmt=".jpg", quality=95):
    """Encode an HWC uint8 image (JPEG/PNG with Pillow, else ``.npy``)."""
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = np.asarray(img).astype(np.uint8)
    image = _pil_image()
    if image is None:
        out = _io.BytesIO()
        np.save(out, img, allow_pickle=False)
        return out.getvalue()
    pil = image.fromarray(img.squeeze() if img.shape[-1] == 1 else img)
    out = _io.BytesIO()
    fmt = {"jpg": "JPEG", "jpeg": "JPEG",
           "png": "PNG"}[img_fmt.lstrip(".").lower()]
    pil.save(out, format=fmt, quality=quality)
    return out.getvalue()


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode to a host uint8 NDArray (HWC)."""
    return _host(imdecode_bytes(buf, flag), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def _linear_weights(m, n):
    """(m, n) float32 weights taking an axis of ``m`` samples to ``n``:
    ``jax.image.resize``'s ``compute_weight_mat`` for the linear kernel
    with antialiasing (scale ``n / m``, no translation)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(inv_scale) - np.float32(0.0) - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0)).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _resize_hwc(arr, h, w, linear):
    """``arr`` (H, W, C) resized to (h, w, C), as ``jax.image.resize``
    with ``method="bilinear"`` (linear, antialiased; float32) or
    ``"nearest"`` (the input dtype) does it."""
    out = arr
    for axis, n in ((0, h), (1, w)):
        m = out.shape[axis]
        if m == n:
            continue
        if linear:
            wts = _linear_weights(m, n)
            out = np.moveaxis(np.tensordot(out, wts, axes=([axis], [0])),
                              -1, axis)
        else:
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(np.int32)
            out = np.take(out, idx, axis=axis)
    return np.ascontiguousarray(out, dtype=np.float32 if linear else None)


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to ``(h, w)``: bilinear for ``interp`` != 0,
    else nearest; a uint8 input gives uint8 (truncated), as in the JAX
    package."""
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = _resize_hwc(arr.astype(np.float32), h, w, bool(interp))
    return _host(out.astype(np.uint8) if _is_uint8(src) else out)


def _is_uint8(x):
    d = getattr(x, "dtype", None)
    return d is not None and np.dtype(d) == np.uint8


def resize_short(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = NDArray(src.tensor[y0 : y0 + h, x0 : x0 + w], ctx=src.ctx)
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, None, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, None, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


# ---------------------------------------------------------------------------
# Augmenters
# ---------------------------------------------------------------------------
class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return NDArray(torch.flip(src.tensor, [1]), ctx=src.ctx)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, src):
        x = src.astype(np.float32)
        if self.brightness > 0:
            alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
            x = x * alpha
        if self.contrast > 0:
            alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
            gray_mean = x.asnumpy().mean()
            x = x * alpha + gray_mean * (1 - alpha)
        if self.saturation > 0:
            alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
            coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)
            gray = (x.asnumpy() * coef).sum(axis=2, keepdims=True)
            x = x * alpha + _host(gray * (1.0 - alpha))
        return x


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + _host(rgb.reshape(1, 1, 3))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=list(np.ravel(mean)),
                         std=None if std is None else list(np.ravel(std)))
        self.mean = None if mean is None else \
            _host(np.asarray(mean).reshape(1, 1, -1))
        self.std = None if std is None else \
            _host(np.asarray(std).reshape(1, 1, -1))

    def __call__(self, src):
        return color_normalize(src.astype(np.float32), self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.any(np.asarray(mean) > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(object):
    """Image iterator over .rec files or image lists; batches on the host."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", seed=0, **kwargs):
        from ..io import DataBatch, DataDesc

        assert path_imgrec or path_imglist or imglist or path_root
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self._databatch = DataBatch
        if path_imgrec:
            from .. import recordio

            if path_imgidx is None:
                path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                     path_imgrec, "r")
            self.imgidx = list(self.imgrec.keys)
            self.imglist = None
        else:
            self.imgrec = None
            entries = []
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.array([float(x) for x in parts[1:-1]],
                                         dtype=np.float32)
                        entries.append((label if len(label) > 1
                                        else float(label[0]), parts[-1]))
            elif imglist:
                for item in imglist:
                    entries.append((item[0], item[1]))
            self.imglist = entries
            self.path_root = path_root or "."
            self.imgidx = list(range(len(entries)))
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(
            label_name, (batch_size,) if label_width == 1
            else (batch_size, label_width))]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "pca_noise", "inter_method")})
        self.cur = 0
        mixed, self.seq = partition_rng_and_shard(seed, part_index,
                                                  num_parts, self.imgidx)
        self._rand = random.Random(mixed)
        if shuffle:
            self._rand.shuffle(self.seq)

    def reset(self):
        self.cur = 0
        if self.shuffle:
            self._rand.shuffle(self.seq)

    def __iter__(self):
        return self

    def next_sample(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            from .. import recordio

            s = self.imgrec.read_idx(idx)
            header, img = recordio.unpack(s)
            return header.label, imdecode_bytes(img)
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, imdecode_bytes(f.read())

    def next(self):
        from ..io import DataBatch

        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              dtype=np.float32)
        shape = self.provide_label[0].shape
        batch_label = np.zeros(shape, dtype=np.float32)
        i = 0
        pad = 0
        while i < self.batch_size:
            try:
                label, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                break
            data = _host(img)
            for aug in self.auglist:
                data = aug(data)
            arr = data.asnumpy()
            if arr.ndim == 3 and arr.shape[2] in (1, 3):
                arr = arr.transpose(2, 0, 1)
            batch_data[i] = arr
            batch_label[i] = label if np.isscalar(label) \
                else np.asarray(label)[: self.label_width]
            i += 1
        return DataBatch(
            data=[_host(batch_data)], label=[_host(batch_label)], pad=pad,
            provide_data=self.provide_data, provide_label=self.provide_label,
        )

    def __next__(self):
        return self.next()
