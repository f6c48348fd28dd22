"""``sym``: the symbolic graph API, with one generated function per
registered op (``sym.Convolution``, ``sym.FusedBottleneckUnit``, ...), and
the ``sym.contrib``, ``sym.linalg`` and ``sym.random`` namespaces
(``sym.contrib.MultiBoxPrior``, ...)."""
import sys as _sys

from ..ndarray.register import populate_module as _populate
from .register import make_symbol_func as _make
from .symbol import (Group, Symbol, Variable, load, load_json,  # noqa: F401
                     var)

_populate(_sys.modules[__name__], _make, Symbol)
