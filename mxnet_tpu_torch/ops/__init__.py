"""Operators of the PyTorch port (counterpart of ``mxnet_tpu/ops``): the
ops of the image-serving and training graphs, the tensor ops behind
``NDArray``, the optimizer update ops, the fused ``RNN``, the random
samplers and the contrib and region-based vision ops, registered in
:mod:`.registry` on import."""
from . import contrib, fused, nn, optimizer_ops, random_ops  # noqa: F401
from . import rnn, tensor, vision  # noqa: F401
from .registry import OpDef, get, list_ops, register  # noqa: F401
