"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib``): the op
namespaces ``ndarray``/``symbol`` alias ``mx.nd.contrib``/
``mx.sym.contrib``, the detection metrics of :mod:`.eval_metric` and the
TensorBoard callback of :mod:`.tensorboard`."""
from ..ndarray import contrib as ndarray  # noqa: F401
from ..symbol import contrib as symbol  # noqa: F401
from . import tensorboard  # noqa: F401
from .eval_metric import MApMetric, VOC07MApMetric  # noqa: F401
