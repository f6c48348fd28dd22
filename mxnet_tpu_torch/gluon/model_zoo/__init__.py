"""The Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import model_store, vision  # noqa: F401
