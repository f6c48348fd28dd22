"""Sparse NDArrays: row_sparse and csr storage (counterpart of
``mxnet_tpu/ndarray/sparse.py``).

A sparse array is a structured dense pair: ``RowSparseNDArray`` holds
(values, indices), ``values[i]`` being row ``indices[i]`` of the dense
view; ``CSRNDArray`` holds (data, indices, indptr). Every dense op takes
one through its dense view (the ``tensor`` of a sparse array densifies),
as the JAX package's ``_data()`` does; the first such fallback of each
storage type logs a warning (``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``).

A row-sparse array is canonical: its indices are unique and sorted, and
duplicates are summed when it is made (``row_sparse_array``, ``add``).
The index bookkeeping stays on the array's device (``torch.unique``),
where the JAX package goes through host numpy; the results are the same.

The compute paths: ``dot`` of a CSR lhs and a dense rhs (``csr·dense``
and ``csrᵀ·dense``, a vector rhs too) is a gather and a segment sum over
the stored elements, never a dense matrix; the lazy updates
(``sgd_update_rsp`` with and without momentum, ``adam_update_rsp``) touch
only the rows present in the gradient, and every other row of the weight
and of its states stays bit for bit as it was. Every sum over a segment
is ``torch.segment_reduce`` over sorted segments (one thread a segment on
the card, in a fixed order), so two runs give the same bits: no atomic
``index_add_``.

Index arrays are int64, as the caller asks: torch holds 64-bit integers,
where the JAX package (x64 off) stores them as int32. The values agree.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import config
from ..base import MXNetError
from ..context import current_context
from .ndarray import NDArray, array, invoke, zeros as nd_zeros

log = logging.getLogger(__name__)

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "dot", "add",
           "retain_rows", "sgd_update_rsp", "adam_update_rsp", "zeros"]


_FALLBACK_LOGGED = set()


def _log_fallback(stype):
    """Warn the first time a sparse array of ``stype`` is densified for a
    dense op, unless ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE`` is 0."""
    if stype in _FALLBACK_LOGGED:
        return
    _FALLBACK_LOGGED.add(stype)
    if config.get_strict_bool("MXNET_STORAGE_FALLBACK_LOG_VERBOSE"):
        log.warning("storage fallback: a %s array is densified for a dense "
                    "op (set MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0 to "
                    "silence this)", stype)


def _as_nd(x, ctx, dtype=None):
    return x if isinstance(x, NDArray) else array(x, ctx=ctx, dtype=dtype)


class BaseSparseNDArray(NDArray):
    """A sparse array: its parts in ``_aux``, its dense view as ``tensor``
    (made at each read, as the JAX package's ``_data()``)."""

    __slots__ = ("_aux", "_full_shape", "_stype")

    def _init_sparse(self, aux, shape, stype, ctx):
        # NDArray.__init__ would set the tensor slot, which a sparse array
        # reads through the ``_t`` property instead
        self._aux = aux
        self._full_shape = tuple(int(s) for s in shape)
        self._stype = stype
        self._ctx = ctx if ctx is not None else aux["values"].context
        self._grad = None
        self._grad_req = "null"

    @property
    def _t(self):
        _log_fallback(self._stype)
        return self.tostype("default").tensor

    @property
    def stype(self):
        return self._stype

    @property
    def shape(self):
        return self._full_shape

    @property
    def ndim(self):
        return len(self._full_shape)

    @property
    def size(self):
        return int(np.prod(self._full_shape)) if self._full_shape else 1

    @property
    def dtype(self):
        return self._aux["values"].dtype

    @property
    def data(self):
        return self._aux["values"]

    @property
    def indices(self):
        return self._aux["indices"]

    def wait_to_read(self):
        self._aux["values"].wait_to_read()

    wait_to_write = wait_to_read

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self._full_shape)),
                                  self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """(values, indices): ``values[i]`` is row ``indices[i]`` of the dense
    view."""

    def __init__(self, data, indices, shape, ctx=None):
        self._init_sparse({"values": data, "indices": indices}, shape,
                          "row_sparse", ctx)

    def _rebind_sparse(self, other):
        self._aux = other._aux
        self._full_shape = other._full_shape

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype != "default":
            raise MXNetError("cannot convert row_sparse to %r" % stype)
        vals = self._aux["values"].tensor.detach()
        idx = self._aux["indices"].tensor.to(vals.device).long()
        dense = vals.new_zeros(self._full_shape)
        # canonical invariant: the indices are unique, so a copy is the
        # sum (and a row_sparse_pull of repeated row ids stays right)
        if idx.numel():
            dense.index_copy_(0, idx, vals.reshape(
                (idx.numel(),) + self._full_shape[1:]))
        return NDArray(dense, self._ctx)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            other._rebind_sparse(RowSparseNDArray(
                self.data.copy(), self.indices.copy(), self._full_shape,
                ctx=other._ctx))
            return other
        return self.tostype("default").copyto(other)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self.indices.copy(),
                                self._full_shape, ctx=self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """CSR: (data, indices, indptr)."""

    def __init__(self, data, indices, indptr, shape, ctx=None):
        self._init_sparse({"values": data, "indices": indices,
                           "indptr": indptr}, shape, "csr", ctx)

    @property
    def indptr(self):
        return self._aux["indptr"]

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype != "default":
            raise MXNetError("cannot convert csr to %r" % stype)
        vals = self._aux["values"].tensor.detach()
        cols = self._aux["indices"].tensor.to(vals.device).long()
        ptr = self._aux["indptr"].tensor.to(vals.device).long()
        dense = vals.new_zeros(self._full_shape)
        rows = _csr_row_ids(ptr, vals.shape[0])
        dense[rows, cols] = vals
        return NDArray(dense, self._ctx)

    def copy(self):
        return CSRNDArray(self.data.copy(), self.indices.copy(),
                          self.indptr.copy(), self._full_shape,
                          ctx=self._ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A row-sparse array from ``(data, indices)`` (canonicalized:
    duplicates summed, indices sorted) or from a dense array."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _as_nd(data, ctx, dtype)
        indices = _as_nd(indices, ctx, np.int64)
        if shape is None:
            raise MXNetError("row_sparse_array: shape required with (data, "
                             "indices)")
        # user-supplied indices may repeat or be unsorted; every consumer
        # (the densify, the lazy updates) assumes the canonical invariant
        vals, idx = _canonicalize(data.tensor.detach(),
                                  indices.tensor.to(data.tensor.device))
        return RowSparseNDArray(NDArray(vals, ctx), NDArray(idx.long(), ctx),
                                shape, ctx=ctx)
    return cast_storage(_as_nd(arg1, ctx, dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSR array from ``(data, indices, indptr)`` or from a dense
    array."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix: shape required with (data, "
                             "indices, indptr)")
        return CSRNDArray(_as_nd(data, ctx, dtype),
                          _as_nd(indices, ctx, np.int64),
                          _as_nd(indptr, ctx, np.int64), shape, ctx=ctx)
    return cast_storage(_as_nd(arg1, ctx, dtype), "csr")


def cast_storage(arr, stype):
    """Dense <-> sparse conversion, on the array's device."""
    if stype == "default":
        return arr.tostype("default") if isinstance(arr, BaseSparseNDArray) \
            else arr
    ctx = arr.context
    dense = arr.tensor.detach()
    if stype == "row_sparse":
        nz = (dense.reshape(dense.shape[0], -1) != 0).any(1).nonzero()
        nz = nz.reshape(-1)
        return RowSparseNDArray(NDArray(dense[nz].clone(), ctx),
                                NDArray(nz.long(), ctx), dense.shape,
                                ctx=ctx)
    if stype == "csr":
        if dense.dim() != 2:
            raise MXNetError("csr requires 2D")
        mask = dense != 0
        rows, cols = mask.nonzero(as_tuple=True)   # row-major order
        counts = mask.sum(1)
        indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return CSRNDArray(NDArray(dense[rows, cols].clone(), ctx),
                          NDArray(cols.long(), ctx),
                          NDArray(indptr.long(), ctx), dense.shape, ctx=ctx)
    raise MXNetError("unknown stype %r" % stype)


# ---------------------------------------------------------------------------
# the compute paths
# ---------------------------------------------------------------------------
def _csr_row_ids(indptr, nnz):
    """Row id of each stored element: repeat(arange(R), diff(indptr))."""
    counts = indptr[1:] - indptr[:-1]
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=indptr.device), counts,
        output_size=int(nnz))


def _segment_sum(data, lengths):
    """Sums over consecutive segments of ``data`` (lengths may be 0),
    one output row a segment, in a fixed order."""
    if data.shape[0] == 0:
        return data.new_zeros((lengths.shape[0],) + tuple(data.shape[1:]))
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)


def _col_segments(cols):
    """``(order, unique columns, counts)``: the stored elements sorted by
    column (stable), and the runs of each column."""
    order = torch.argsort(cols, stable=True)
    uniq, counts = torch.unique_consecutive(cols[order], return_counts=True)
    return order, uniq, counts


def _csr_dot(vals, cols, ptr, dense, n_seg, transpose):
    rows = _csr_row_ids(ptr, vals.shape[0])
    if transpose:
        # out[c] = sum over stored (r, c) of val * dense[r]
        order, uniq, counts = _col_segments(cols)
        contrib = vals[order, None] * dense[rows[order]]
        out = dense.new_zeros((n_seg, dense.shape[1]))
        if uniq.numel():
            out.index_copy_(0, uniq, _segment_sum(contrib, counts))
        return out
    contrib = vals[:, None] * dense[cols]             # (nnz, N)
    return _segment_sum(contrib, ptr[1:] - ptr[:-1])


def dot(lhs, rhs, transpose_a=False):
    """``dot(csr, dense)`` and ``dot(csr.T, dense)`` over the stored
    elements; any other sparse operand takes the dense ``dot``."""
    if not isinstance(lhs, CSRNDArray):
        if isinstance(lhs, BaseSparseNDArray) or \
                isinstance(rhs, BaseSparseNDArray):
            lhs = lhs.tostype("default") \
                if isinstance(lhs, BaseSparseNDArray) else lhs
            rhs = rhs.tostype("default") \
                if isinstance(rhs, BaseSparseNDArray) else rhs
        return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a})
    vals = lhs.data.tensor.detach()
    if isinstance(rhs, NDArray):
        dense = rhs.tensor.detach()
    else:
        dense = torch.as_tensor(np.asarray(rhs), device=vals.device)
    vec = dense.dim() == 1
    if vec:
        dense = dense[:, None]
    cols = lhs.indices.tensor.to(vals.device).long()
    ptr = lhs.indptr.tensor.to(vals.device).long()
    rows, n_cols = lhs.shape
    with torch.no_grad():
        out = _csr_dot(vals, cols, ptr, dense,
                       n_cols if transpose_a else rows, bool(transpose_a))
    if vec:
        out = out[:, 0]
    return NDArray(out, lhs.context)


def _canonicalize(vals, idx):
    """``(values, indices)`` with unique sorted indices, duplicates
    summed (on the values' device)."""
    idx = idx.reshape(-1)
    if idx.numel() == 0:
        return vals, idx.long()
    uniq, inverse, counts = torch.unique(idx, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    if uniq.numel() == idx.numel():
        if torch.equal(idx, uniq):
            return vals, idx
        return vals[torch.argsort(idx)], uniq
    order = torch.argsort(inverse, stable=True)
    return _segment_sum(vals[order], counts), uniq


def add(lhs, rhs):
    """Sum of two row-sparse arrays, kept sparse and canonical (the
    kvstore's aggregation of row-sparse gradients)."""
    if not (isinstance(lhs, RowSparseNDArray)
            and isinstance(rhs, RowSparseNDArray)):
        raise MXNetError("sparse.add expects two RowSparseNDArrays")
    if lhs.shape != rhs.shape:
        raise MXNetError("shape mismatch %s vs %s" % (lhs.shape, rhs.shape))
    dev = lhs.data.tensor.device
    vals = torch.cat([lhs.data.tensor.detach(),
                      rhs.data.tensor.detach().to(dev)], 0)
    idx = torch.cat([lhs.indices.tensor.long(),
                     rhs.indices.tensor.to(dev).long()], 0)
    vals, idx = _canonicalize(vals, idx)
    return RowSparseNDArray(NDArray(vals, lhs.context),
                            NDArray(idx.long(), lhs.context), lhs.shape,
                            ctx=lhs.context)


def retain_rows(data, indices):
    """The rows of the row-sparse ``data`` whose indices are in
    ``indices``, as a row-sparse array (the sparse form of
    ``_sparse_retain``, ``mx.nd.sparse.retain``)."""
    idx = data.indices.tensor.long()
    want = indices.tensor if isinstance(indices, NDArray) else \
        torch.as_tensor(np.asarray(indices))
    keep = torch.isin(idx, want.to(idx.device).long())
    return RowSparseNDArray(NDArray(data.data.tensor[keep], data.context),
                            NDArray(idx[keep], data.context), data.shape,
                            ctx=data.context)


def _rows(weight, grad):
    """The canonical gradient rows on the weight's device."""
    dev = weight.tensor.device
    vals, idx = _canonicalize(grad.data.tensor.detach().to(dev),
                              grad.indices.tensor.to(dev))
    return vals, idx.long()


def _prepared(vals, rows_w, wd, rescale_grad, clip_gradient):
    g = vals * rescale_grad
    if clip_gradient is not None and float(clip_gradient) > 0:
        c = abs(float(clip_gradient))
        g = g.clamp(-c, c)
    return g + wd * rows_w


def sgd_update_rsp(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None, state=None, momentum=0.0):
    """Lazy row-sparse SGD (with momentum when ``state`` is given): only
    the rows present in ``grad`` change, and momentum decays only on
    them."""
    vals, idx = _rows(weight, grad)
    if idx.numel() == 0:
        return weight
    w = weight.tensor
    with torch.no_grad():
        w_rows = w.index_select(0, idx)
        g = _prepared(vals, w_rows, wd, rescale_grad, clip_gradient)
        if state is None:
            w.index_copy_(0, idx, w_rows + (-lr * g))
        else:
            mom = state.tensor
            m_rows = momentum * mom.index_select(0, idx) - lr * g
            w.index_copy_(0, idx, w_rows + m_rows)
            mom.index_copy_(0, idx, m_rows)
    return weight


def adam_update_rsp(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=None, t=1):
    """Lazy row-sparse Adam: the moments and the weight change only on
    the rows present in ``grad``."""
    vals, idx = _rows(weight, grad)
    if idx.numel() == 0:
        return weight
    lr_t = lr * ((1.0 - beta2 ** t) ** 0.5) / (1.0 - beta1 ** t)
    w, m, v = weight.tensor, mean.tensor, var.tensor
    with torch.no_grad():
        w_rows = w.index_select(0, idx)
        g = _prepared(vals, w_rows, wd, rescale_grad, clip_gradient)
        m_rows = beta1 * m.index_select(0, idx) + (1 - beta1) * g
        v_rows = beta2 * v.index_select(0, idx) + (1 - beta2) * g * g
        upd = lr_t * m_rows / (torch.sqrt(v_rows) + epsilon)
        w.index_copy_(0, idx, w_rows + (-upd))
        m.index_copy_(0, idx, m_rows)
        v.index_copy_(0, idx, v_rows)
    return weight


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``."""
    ctx = ctx or current_context()
    if stype == "default":
        return nd_zeros(shape, ctx=ctx, dtype=dtype)
    dtype = dtype or np.float32
    if stype == "row_sparse":
        return RowSparseNDArray(
            nd_zeros((0,) + tuple(shape[1:]), ctx=ctx, dtype=dtype),
            nd_zeros((0,), ctx=ctx, dtype=np.int64), shape, ctx=ctx)
    if stype == "csr":
        return CSRNDArray(nd_zeros((0,), ctx=ctx, dtype=dtype),
                          nd_zeros((0,), ctx=ctx, dtype=np.int64),
                          nd_zeros((shape[0] + 1,), ctx=ctx, dtype=np.int64),
                          shape, ctx=ctx)
    raise MXNetError("unknown stype %r" % stype)
