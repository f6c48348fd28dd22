"""``sym``: the symbolic graph API, with one generated function per
registered op (``sym.Convolution``, ``sym.FusedBottleneckUnit``, ...), and
the ``sym.contrib``, ``sym.linalg`` and ``sym.random`` namespaces
(``sym.contrib.MultiBoxPrior``, ...), and ``sym.zeros``/``sym.ones``."""
import sys as _sys

from ..ndarray.register import populate_module as _populate
from .register import make_symbol_func as _make
from .symbol import (Group, Symbol, Variable, load, load_json,  # noqa: F401
                     var)

_populate(_sys.modules[__name__], _make, Symbol)


def zeros(shape, dtype="float32", **kwargs):
    """A ``_zeros`` node of ``shape`` (``name`` and other keywords are
    ignored, as in the JAX package: the node takes an automatic name)."""
    from ..ops.registry import get
    from .register import create_symbol

    return create_symbol(get("_zeros"), [], {"shape": tuple(shape),
                                             "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    """A ``_ones`` node of ``shape`` (keywords ignored, as ``zeros``)."""
    from ..ops.registry import get
    from .register import create_symbol

    return create_symbol(get("_ones"), [], {"shape": tuple(shape),
                                            "dtype": dtype})
