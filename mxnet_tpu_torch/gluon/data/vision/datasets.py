"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): ``MNIST``,
``FashionMNIST``, ``CIFAR10``, ``CIFAR100``, ``ImageRecordDataset`` and
``ImageFolderDataset``.

They read local files only (MNIST idx files, gzipped or not; CIFAR binary
batches; RecordIO packs; class folders of images or ``.npy`` arrays):
nothing downloads, and a missing file raises naming it. Images are HWC
uint8 NDArrays on the current context, labels int32 (a record's header
label for ``ImageRecordDataset``).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ....ndarray import ndarray as nd
from ..dataset import Dataset, RecordFileDataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", "")
        self._train_label = ("train-labels-idx1-ubyte.gz", "")
        self._test_data = ("t10k-images-idx3-ubyte.gz", "")
        self._test_label = ("t10k-labels-idx1-ubyte.gz", "")
        super().__init__(root, transform)

    def _open(self, fname):
        path = os.path.join(self._root, fname)
        if not os.path.exists(path) and path.endswith(".gz"):
            path = path[:-3]
        if not os.path.exists(path):
            raise MXNetError("MNIST file %s not found (nothing downloads; "
                             "place the files in %s)" % (fname, self._root))
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _get_data(self):
        data_file = self._train_data[0] if self._train else self._test_data[0]
        label_file = self._train_label[0] if self._train else self._test_label[0]
        with self._open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with self._open(data_file) as fin:
            struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1).copy()
        self._data = nd.array(data, dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local binary batches."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3072 + 1)
        return (
            data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
            data[:, 0].astype(np.int32),
        )

    def _get_data(self):
        sub = os.path.join(self._root, "cifar-10-batches-bin")
        base = sub if os.path.isdir(sub) else self._root
        if self._train:
            files = [os.path.join(base, "data_batch_%d.bin" % i) for i in range(1, 6)]
        else:
            files = [os.path.join(base, "test_batch.bin")]
        for f in files:
            if not os.path.exists(f):
                raise MXNetError("CIFAR file %s not found (nothing downloads)" % f)
        data, label = zip(*[self._read_batch(f) for f in files])
        data = np.concatenate(data)
        label = np.concatenate(label)
        self._data = nd.array(data, dtype=np.uint8)
        self._label = label


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3072 + 2)
        return (
            data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
            data[:, 0 + self._fine_label].astype(np.int32),
        )

    def _get_data(self):
        sub = os.path.join(self._root, "cifar-100-binary")
        base = sub if os.path.isdir(sub) else self._root
        name = "train.bin" if self._train else "test.bin"
        f = os.path.join(base, name)
        if not os.path.exists(f):
            raise MXNetError("CIFAR100 file %s not found (nothing downloads)" % f)
        data, label = self._read_batch(f)
        self._data = nd.array(data, dtype=np.uint8)
        self._label = label


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio

        record = super().__getitem__(idx)
        header, img_bytes = recordio.unpack(record)
        from ....image.image import imdecode_bytes

        img = nd.array(imdecode_bytes(img_bytes, self._flag))
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """A dataset of images arranged in class folders."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        if fname.endswith(".npy"):
            img = nd.array(np.load(fname))
        else:
            from ....image.image import imread

            img = imread(fname, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
