"""Contrib recurrent cells (counterpart of ``mxnet_tpu/gluon/contrib/rnn``):
``Conv2DLSTMCell`` and ``VariationalDropoutCell``."""
from .conv_rnn_cell import Conv2DLSTMCell  # noqa: F401
from .rnn_cell import VariationalDropoutCell  # noqa: F401
