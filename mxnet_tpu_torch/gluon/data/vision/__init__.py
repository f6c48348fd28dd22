"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from . import transforms  # noqa: F401
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,  # noqa: F401
                       ImageFolderDataset, ImageRecordDataset)
