"""``mx.nd``: the imperative NDArray API, with one generated function per
registered op (``mx.nd.sum``, ``mx.nd.sgd_mom_update``, ...). A name the
registry does not hold raises ``MXNetError`` naming it as not ported.

``mx.nd.sparse`` is the real submodule (``sparse.py``): the ``_sparse_*``
ops land on it. ``dot`` with a CSR lhs, ``cast_storage`` to a sparse type
and ``_sparse_retain`` of a row-sparse array take the sparse forms; the
dense op kernels are their fallbacks."""
import sys as _sys

from . import register as _register
from .ndarray import (NDArray, arange, array, concatenate, empty,  # noqa
                      full, imdecode, invoke, moveaxis, onehot_encode, ones,
                      waitall, zeros, zeros_like)
from .utils import load, save  # noqa: F401

# the real sparse submodule first, so the op namespace lands on it
from . import sparse  # noqa: F401
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: F401

_register.populate_module(_sys.modules[__name__])
__getattr__ = _register.not_ported("mx.nd")

_dense_dot = dot  # noqa: F821  (generated above by populate_module)
_dense_cast_storage = cast_storage  # noqa: F821
_dense_sparse_retain = _sparse_retain  # noqa: F821


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    if isinstance(lhs, CSRNDArray) and not transpose_b:
        return sparse.dot(lhs, rhs, transpose_a=transpose_a)
    return _dense_dot(lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b, **kwargs)


def cast_storage(data, stype="default", **kwargs):
    if stype != "default" or isinstance(data, sparse.BaseSparseNDArray):
        return sparse.cast_storage(data, stype)
    return _dense_cast_storage(data, stype=stype, **kwargs)


def _sparse_retain(data, indices, **kwargs):
    if isinstance(data, RowSparseNDArray):
        return sparse.retain_rows(data, indices)
    return _dense_sparse_retain(data, indices, **kwargs)


dot.__doc__ = _dense_dot.__doc__
cast_storage.__doc__ = _dense_cast_storage.__doc__
_sparse_retain.__doc__ = _dense_sparse_retain.__doc__
sparse.retain = _sparse_retain
