"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib``): the op
namespaces ``ndarray``/``symbol`` alias ``mx.nd.contrib``/
``mx.sym.contrib``, and the detection metrics of :mod:`.eval_metric`.
``contrib.tensorboard`` is not ported yet (ROADMAP.md Queue A item 13)."""
from ..ndarray import contrib as ndarray  # noqa: F401
from ..symbol import contrib as symbol  # noqa: F401
from .eval_metric import MApMetric, VOC07MApMetric  # noqa: F401
