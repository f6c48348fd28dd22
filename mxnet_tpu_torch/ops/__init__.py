"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``): the
ops of the image-serving and training graphs, the tensor ops behind
``NDArray``, the optimizer update ops and the fused ``RNN``, registered in
:mod:`.registry` on import."""
from . import fused, nn, optimizer_ops, rnn, tensor  # noqa: F401
from .registry import OpDef, get, list_ops, register  # noqa: F401
