"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``): the
ops of the image-serving and training graphs, the tensor ops behind
``NDArray`` and the optimizer update ops, registered in :mod:`.registry`
on import."""
from . import fused, nn, optimizer_ops, tensor  # noqa: F401  (registration)
from .registry import OpDef, get, list_ops, register  # noqa: F401
