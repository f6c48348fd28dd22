"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): ``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``Resize``, ``CenterCrop``,
``RandomResizedCrop``, ``RandomFlipLeftRight`` and ``RandomFlipTopBottom``.

Images are HWC arrays, as the datasets give them. The random transforms
draw from numpy's global generator in the JAX package's order (the crop's
area and aspect, then its corner; one ``rand()`` a flip), so one
``np.random.seed`` gives both packages the same crops and flips. The
bilinear resize is ``jax.image.resize``'s (antialiased, float32;
``image._resize_hwc``), cast back to the input's dtype.
"""
from __future__ import annotations

import numpy as np

from ....image.image import _resize_hwc
from ....ndarray import ndarray as nd
from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom"]


class Compose(Sequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW). The
    scaling is the product by float32(1/255), which is what the JAX
    package's division by 255 computes (XLA makes a division by a constant
    that product), so both give the same bits."""

    def __init__(self):
        super().__init__()

    def forward(self, x):
        out = x.astype(np.float32) * float(np.float32(1.0 / 255.0))
        if out.ndim == 3:
            return out.transpose((2, 0, 1))
        return out.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std`` a channel, on CHW input."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (x - nd.array(self._mean, ctx=x.context)) / \
            nd.array(self._std, ctx=x.context)


def _resized(x, size):
    """HWC ``x`` resized to ``size`` = (w, h), bilinear, in x's dtype."""
    arr = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
    out = _resize_hwc(arr.astype(np.float32), size[1], size[0], True)
    return nd.array(out.astype(arr.dtype), ctx=x.context, dtype=arr.dtype)


class Resize(Block):
    """Bilinear resize of an HWC image to ``size`` (an int, or (w, h))."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        return _resized(x, self._size)


def _crop(x, y0, x0, h, w):
    return NDArray(x.tensor[y0:y0 + h, x0:x0 + w].clone(), x.context)


class CenterCrop(Block):
    """The central ``size`` (an int, or (w, h)) window of an HWC image."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        height, width = x.shape[0], x.shape[1]
        return _crop(x, max((height - h) // 2, 0), max((width - w) // 2, 0),
                     h, w)


class RandomResizedCrop(Block):
    """A random crop of ``scale`` of the area and ``ratio`` aspect, resized
    to ``size``; after 10 misses, the center crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        height, width = x.shape[0], x.shape[1]
        area = height * width
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= width and h <= height:
                x0 = np.random.randint(0, width - w + 1)
                y0 = np.random.randint(0, height - h + 1)
                return _resized(_crop(x, y0, x0, h, w), self._size)
        return CenterCrop(self._size).forward(x)


class RandomFlipLeftRight(Block):
    """Flip the width axis with probability 1/2."""

    def __init__(self):
        super().__init__()

    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(x.tensor.flip(1), x.context)
        return x


class RandomFlipTopBottom(Block):
    """Flip the height axis with probability 1/2."""

    def __init__(self):
        super().__init__()

    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(x.tensor.flip(0), x.context)
        return x
