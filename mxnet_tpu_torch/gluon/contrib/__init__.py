"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the
contrib recurrent cells."""
from . import rnn  # noqa: F401
