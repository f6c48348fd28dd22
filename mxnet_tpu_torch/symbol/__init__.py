"""``sym``: the symbolic graph API, with one generated function per
registered op (``sym.Convolution``, ``sym.FusedBottleneckUnit``, ...)."""
import sys as _sys

from .. import ops as _ops
from .register import make_symbol_func as _make
from .symbol import (Group, Symbol, Variable, load, load_json,  # noqa: F401
                     var)

for _name in _ops.list_ops():
    setattr(_sys.modules[__name__], _name, _make(_ops.get(_name)))
