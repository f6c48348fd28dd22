"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``): the
ops of the image-serving and training graphs, the tensor ops behind
``NDArray``, the optimizer update ops, the fused ``RNN``, the random
samplers, the contrib and region-based vision ops and the int8 ops of
quantized serving, registered in :mod:`.registry` on import."""
from . import contrib, fused, nn, optimizer_ops, quantized  # noqa: F401
from . import custom, random_ops, rnn, tensor, vision  # noqa: F401
from .registry import OpDef, get, list_ops, register  # noqa: F401
