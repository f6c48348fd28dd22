"""Gluon's data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, the ``DataLoader`` and ``vision`` (its datasets and
transforms)."""
from . import vision  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
