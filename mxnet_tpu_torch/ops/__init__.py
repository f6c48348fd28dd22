"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``): the
ops of the image-serving path, registered in :mod:`.registry` on import."""
from . import fused, nn, tensor  # noqa: F401  (registration side effects)
from .registry import OpDef, get, list_ops, register  # noqa: F401
