"""``mx.nd``: the imperative NDArray API, with one generated function per
registered op (``mx.nd.sum``, ``mx.nd.sgd_mom_update``, ...). A name the
registry does not hold raises ``MXNetError`` naming it as not ported."""
import sys as _sys

from . import register as _register
from .ndarray import (NDArray, arange, array, concatenate, empty,  # noqa
                      full, invoke, ones, waitall, zeros, zeros_like)
from .utils import load, save  # noqa: F401

_register.populate_module(_sys.modules[__name__])
__getattr__ = _register.not_ported("mx.nd")
