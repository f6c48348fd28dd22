"""Gluon's data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers and the ``DataLoader``. ``vision`` (its datasets and transforms)
is not ported yet and raises by name on use."""
from .._not_ported import not_ported_module
from .dataloader import DataLoader  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)

vision = not_ported_module("mxnet_tpu_torch.gluon.data.vision",
                           "the vision datasets and transforms")
