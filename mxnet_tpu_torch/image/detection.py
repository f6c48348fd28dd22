"""Detection image pipeline: bbox-aware augmenters + ImageDetIter
(counterpart of ``mxnet_tpu/image/detection.py``).

The label convention of MXNet's detection iterators: a flat per-image
label ``[header_width, object_width, extras..., objects...]`` where each
object is ``[id, xmin, ymin, xmax, ymax, ...]`` with coordinates
normalized to [0, 1]. Augmenters transform (image, label) pairs; the
pipeline is host-side numpy, and its batches stay on the host.
"""
from __future__ import annotations

import json
import random as pyrandom

import numpy as np

from ..base import MXNetError
from . import image as img_mod


class DetAugmenter(object):
    """Detection augmenter base."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; label passes through."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps()
                         if hasattr(augmenter, "dumps") else str(augmenter))
        self.augmenter = augmenter

    def __call__(self, src, label):
        out = self.augmenter(img_mod._host(src))
        return np.asarray(out.asnumpy(), dtype=np.float32), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter to apply, or skip."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and flip xmin/xmax."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = src[:, ::-1, :].copy()
            label = label.copy()
            xmin = 1.0 - label[:, 3]
            xmax = 1.0 - label[:, 1]
            label[:, 1] = xmin
            label[:, 3] = xmax
        return src, label


def _bbox_coverage(label, crop):
    """Fraction of each object's area inside crop (x1,y1,x2,y2 normalized)."""
    x1 = np.maximum(label[:, 1], crop[0])
    y1 = np.maximum(label[:, 2], crop[1])
    x2 = np.minimum(label[:, 3], crop[2])
    y2 = np.minimum(label[:, 4], crop[3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = (label[:, 3] - label[:, 1]) * (label[:, 4] - label[:, 2])
    return np.where(area > 0, inter / np.maximum(area, 1e-12), 0.0)


def _update_labels(label, crop, min_eject_coverage):
    """Clip/shift labels into a crop region; eject low-coverage objects."""
    cov = _bbox_coverage(label, crop)
    keep = cov >= min_eject_coverage
    if not np.any(keep):
        return None
    out = label[keep].copy()
    w = crop[2] - crop[0]
    h = crop[3] - crop[1]
    out[:, 1] = np.clip((out[:, 1] - crop[0]) / w, 0, 1)
    out[:, 3] = np.clip((out[:, 3] - crop[0]) / w, 0, 1)
    out[:, 2] = np.clip((out[:, 2] - crop[1]) / h, 0, 1)
    out[:, 4] = np.clip((out[:, 4] - crop[1]) / h, 0, 1)
    return out


class DetRandomCropAug(DetAugmenter):
    """Random crop with constraints on object coverage / aspect / area."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w, _ = src.shape
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(area * ratio))
            ch = min(1.0, np.sqrt(area / ratio))
            x0 = pyrandom.uniform(0, 1 - cw)
            y0 = pyrandom.uniform(0, 1 - ch)
            crop = (x0, y0, x0 + cw, y0 + ch)
            cov = _bbox_coverage(label, crop)
            if cov.max(initial=0.0) < self.min_object_covered:
                continue
            new_label = _update_labels(label, crop, self.min_eject_coverage)
            if new_label is None:
                continue
            px0, py0 = int(x0 * w), int(y0 * h)
            px1, py1 = int((x0 + cw) * w), int((y0 + ch) * h)
            if px1 <= px0 + 1 or py1 <= py0 + 1:
                continue
            return src[py0:py1, px0:px1, :], new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion padding; boxes shrink into the padded canvas."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w, c = src.shape
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            if area < 1.0:
                continue
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            nw = int(w * min(4.0, np.sqrt(area * ratio)))
            nh = int(h * min(4.0, np.sqrt(area / ratio)))
            if nw <= w or nh <= h:
                continue
            x0 = pyrandom.randint(0, nw - w)
            y0 = pyrandom.randint(0, nh - h)
            canvas = np.empty((nh, nw, c), dtype=src.dtype)
            canvas[:] = np.asarray(self.pad_val, dtype=src.dtype)[:c]
            canvas[y0:y0 + h, x0:x0 + w, :] = src
            out = label.copy()
            out[:, 1] = (out[:, 1] * w + x0) / nw
            out[:, 3] = (out[:, 3] * w + x0) / nw
            out[:, 2] = (out[:, 2] * h + y0) / nh
            out[:, 4] = (out[:, 4] * h + y0) / nh
            return canvas, out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 3.0),
                       min_eject_coverage=0.3, max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Build the standard detection augmenter list."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(img_mod.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (min(area_range[0], 1.0), min(area_range[1], 1.0)),
            min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(
            aspect_ratio_range,
            (max(1.0, area_range[0]), max(1.0, area_range[1])),
            max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        # bool True = reference python default 0.5; a float is honored as
        # the flip probability (C++ iterator's rand_mirror_prob)
        auglist.append(DetHorizontalFlipAug(
            0.5 if rand_mirror is True else float(rand_mirror)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            img_mod.ColorJitterAug(brightness, contrast, saturation)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(img_mod.ColorNormalizeAug(
            mean if mean is not None else np.zeros(3),
            std if std is not None else np.ones(3))))
    return auglist


class ImageDetIter(img_mod.ImageIter):
    """Detection iterator.

    provide_label: (batch, max_objects, object_width); short images pad
    their object rows with -1 (id=-1 marks an invalid object for
    MultiBoxTarget, same convention as the reference)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_pad", "rand_mirror",
                         "mean", "std", "brightness", "contrast", "saturation",
                         "min_object_covered", "aspect_ratio_range",
                         "area_range", "min_eject_coverage", "max_attempts",
                         "pad_val")})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.det_auglist = list(aug_list)
        from ..io import DataDesc

        max_objects, object_width = self._estimate_label_shape()
        self.max_objects = max_objects
        self.object_width = object_width
        self.provide_label = [DataDesc(
            label_name, (batch_size, max_objects, object_width))]

    # -- label handling ------------------------------------------------------
    @staticmethod
    def _parse_label(label):
        """Flat [header_width, object_width, extras..., objs...] → (N, w)."""
        raw = np.asarray(label, dtype=np.float32).ravel()
        if raw.size < 7:
            raise MXNetError("Label shape is invalid: %r" % (raw.shape,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if (raw.size - header_width) % obj_width != 0:
            raise MXNetError(
                "Label shape %r inconsistent with annotation width %d"
                % (raw.shape, obj_width))
        out = np.reshape(raw[header_width:], (-1, obj_width))
        valid = np.where((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2]))[0]
        if valid.size < 1:
            raise MXNetError("Encountered sample with no valid label")
        return out[valid, :]

    def _iter_labels(self):
        """Yield every raw label WITHOUT decoding images: labels live in
        the record headers / list entries (a 100k-image .rec must not do
        100k JPEG decodes at construction)."""
        if self.imgrec is not None:
            from .. import recordio

            for idx in self.imgidx:
                hdr, _ = recordio.unpack(self.imgrec.read_idx(idx))
                yield hdr.label
        else:
            for label, _fname in self.imglist:
                yield label

    def _estimate_label_shape(self):
        """Scan dataset labels once for (max_objects, object_width)."""
        max_objects, width = 0, 5
        for label in self._iter_labels():
            parsed = self._parse_label(label)
            max_objects = max(max_objects, parsed.shape[0])
            width = max(width, parsed.shape[1])
        if max_objects == 0:
            raise MXNetError("ImageDetIter: dataset has no valid labels")
        return max_objects, width

    def reshape(self, data_shape=None, label_shape=None):
        from ..io import DataDesc

        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(self.provide_data[0].name,
                                          (self.batch_size,)
                                          + self.data_shape)]
        if label_shape is not None:
            if (label_shape[0] < self.max_objects
                    or label_shape[1] < self.object_width):
                # never shrink below the dataset's label extent (that
                # would truncate objects)
                raise MXNetError(
                    "Label shape %r smaller than dataset extent (%d, %d)"
                    % (tuple(label_shape), self.max_objects,
                       self.object_width))
            self.max_objects, self.object_width = label_shape
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + tuple(label_shape))]

    def sync_label_shape(self, it, verbose=False):
        """Grow both iterators' label pads to the common max."""
        assert isinstance(it, ImageDetIter)
        mo = max(self.max_objects, it.max_objects)
        ow = max(self.object_width, it.object_width)
        self.reshape(label_shape=(mo, ow))
        it.reshape(label_shape=(mo, ow))
        return it

    # -- batching ------------------------------------------------------------
    def next(self):
        from ..io import DataBatch

        c, th, tw = self.data_shape
        batch_data = np.zeros((self.batch_size, c, th, tw), np.float32)
        batch_label = np.full(
            (self.batch_size, self.max_objects, self.object_width), -1.0,
            np.float32)
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
            arr = np.asarray(img, dtype=np.float32)
            parsed = self._parse_label(label)
            for aug in self.det_auglist:
                arr, parsed = aug(arr, parsed)
            if arr.shape[0] != th or arr.shape[1] != tw:
                arr = np.asarray(img_mod.imresize(arr, tw, th).asnumpy(),
                                 np.float32)
            n = min(parsed.shape[0], self.max_objects)
            w = min(parsed.shape[1], self.object_width)
            batch_label[i, :n, :w] = parsed[:n, :w]
            batch_data[i] = arr.transpose(2, 0, 1)
            i += 1
        return DataBatch(
            data=[img_mod._host(batch_data)],
            label=[img_mod._host(batch_label)], pad=pad,
            provide_data=self.provide_data, provide_label=self.provide_label,
        )
