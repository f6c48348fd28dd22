"""Tensor ops (counterpart of the matching entries of
``mxnet_tpu/ops/tensor.py``): the graph's ``broadcast_add``, ``_copy``,
``Flatten`` and ``transpose``, and what ``NDArray``'s arithmetic,
comparisons, shape methods and reductions and the optimizers invoke —
the broadcasting binary ops, the ``_*_scalar`` ops, the unary math, the
reductions, ``Reshape`` (MXNet's special codes), ``Cast``, ``clip``,
``dot``, ``take`` and ``Concat``. Names, attributes and output dtypes are
the JAX package's (comparisons and ``argmax`` return the input's dtype
and float32, as there).

Under a data-parallel mesh (``spmd_scope``) each rank holds its rows of
the batch (axis 0). An op whose result over those rows would not be the
rank's rows of its result over the whole batch raises by name
(:func:`_refuse_batch_axis`): the reductions, softmax, log_softmax,
argmax and argmin over axis 0, ``Concat`` on dim 0, a ``transpose`` or
``swapaxes`` that moves axis 0 and a ``Reshape`` whose output rows are not
the input rows' (:func:`_check_batch_rows`). ``Flatten`` and a
``Reshape`` that keeps axis 0 first, or merges it with the axes after it,
run as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_torch
from .registry import register


@register(name="broadcast_add",
          aliases=("elemwise_add", "_plus", "_add", "_Plus"))
def broadcast_add(lhs, rhs):
    return lhs + rhs


def _binary(name, fn, aliases=()):
    register(name=name, aliases=aliases)(fn)


_binary("broadcast_sub", lambda lhs, rhs: lhs - rhs,
        aliases=("elemwise_sub", "_minus", "_sub", "_Minus"))
_binary("broadcast_mul", lambda lhs, rhs: lhs * rhs,
        aliases=("elemwise_mul", "_mul", "_Mul"))
_binary("broadcast_div", lambda lhs, rhs: lhs / rhs,
        aliases=("elemwise_div", "_div", "_Div"))
_binary("broadcast_mod", lambda lhs, rhs: torch.remainder(lhs, rhs),
        aliases=("_mod",))
_binary("broadcast_power", lambda lhs, rhs: torch.pow(lhs, rhs),
        aliases=("_power", "_pow", "_Power"))
_binary("broadcast_maximum", lambda lhs, rhs: torch.maximum(lhs, rhs),
        aliases=("_maximum", "_Maximum"))
_binary("broadcast_minimum", lambda lhs, rhs: torch.minimum(lhs, rhs),
        aliases=("_minimum", "_Minimum"))


def _logic(name, fn, aliases=()):
    def _op(lhs, rhs):
        return fn(lhs, rhs).to(lhs.dtype)

    _op.__name__ = name
    register(name=name, aliases=aliases)(_op)


_logic("broadcast_equal", torch.eq, aliases=("_equal",))
_logic("broadcast_not_equal", torch.ne, aliases=("_not_equal",))
_logic("broadcast_greater", torch.gt, aliases=("_greater",))
_logic("broadcast_greater_equal", torch.ge, aliases=("_greater_equal",))
_logic("broadcast_lesser", torch.lt, aliases=("_lesser",))
_logic("broadcast_lesser_equal", torch.le, aliases=("_lesser_equal",))


def _scalar_op(name, fn, aliases=()):
    def _op(data, scalar=0.0):
        return fn(data, scalar)

    _op.__name__ = name
    register(name=name, aliases=aliases)(_op)


_scalar_op("_plus_scalar", lambda d, s: d + s, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", lambda d, s: d - s, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda d, s: s - d, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", lambda d, s: d * s, aliases=("_MulScalar",))
_scalar_op("_div_scalar", lambda d, s: d / s, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda d, s: s / d, aliases=("_RDivScalar",))
_scalar_op("_mod_scalar", lambda d, s: torch.remainder(d, s))
_scalar_op("_rmod_scalar",
           lambda d, s: torch.remainder(torch.full_like(d, s), d))
_scalar_op("_power_scalar", lambda d, s: torch.pow(d, s),
           aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", lambda d, s: torch.pow(s, d),
           aliases=("_RPowerScalar",))
# maximum/minimum against a 0-d tensor of the scalar split the gradient in
# half at a tie, as jnp.maximum/jnp.minimum do (clamp would pass all of it)
_scalar_op("_maximum_scalar",
           lambda d, s: torch.maximum(d, d.new_full((), s)),
           aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar",
           lambda d, s: torch.minimum(d, d.new_full((), s)),
           aliases=("_MinimumScalar",))
for _name, _cmp in (("_equal_scalar", torch.eq),
                    ("_not_equal_scalar", torch.ne),
                    ("_greater_scalar", torch.gt),
                    ("_greater_equal_scalar", torch.ge),
                    ("_lesser_scalar", torch.lt),
                    ("_lesser_equal_scalar", torch.le)):
    _scalar_op(_name, lambda d, s, _c=_cmp: _c(d, s).to(d.dtype))


@register(name="_copy", aliases=("identity",))
def _copy(data):
    return data


def _unary(name, fn, aliases=()):
    def _op(data):
        return fn(data)

    _op.__name__ = name
    register(name=name, aliases=aliases)(_op)


_unary("relu", lambda data: torch.maximum(data, data.new_zeros(())))
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("negative", lambda data: -data, aliases=("_neg",))
_unary("reciprocal", lambda data: 1.0 / data)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("rint", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("exp", torch.exp)
_unary("log", torch.log)


def _temper(data, temperature):
    if temperature in (None, "None", 1.0):
        return data
    return data / float(temperature)


@register(name="softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax of ``data / temperature``; ``length`` is accepted and
    ignored, as the JAX package does."""
    _refuse_batch_axis("softmax", _norm_axis(axis, data.dim()), data.dim())
    return torch.softmax(_temper(data, temperature), dim=int(axis))


@register(name="log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    _refuse_batch_axis("log_softmax", _norm_axis(axis, data.dim()),
                       data.dim())
    return torch.log_softmax(_temper(data, temperature), dim=int(axis))


@register(name="Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(dtype_torch(dtype))


@register(name="clip")
def clip(data, a_min=0.0, a_max=1.0):
    """``minimum(maximum(x, a_min), a_max)``: half the gradient at either
    bound, as ``jnp.clip`` gives (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(data, data.new_full((), a_min)),
                         data.new_full((), a_max))


@register(name="zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register(name="ones_like")
def ones_like(data):
    return torch.ones_like(data)


def _norm_axis(axis, ndim):
    """``None``/``()`` -> every axis; otherwise a tuple of axes >= 0."""
    if axis is None or axis == () or axis == "None":
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


def _refuse_batch_axis(name, axes, ndim):
    """Under a data-parallel mesh each rank holds its rows of the batch: an
    op over axis 0 would see the rank's rows, not the batch, so it raises
    rather than give a rank-local value."""
    if ndim and 0 in axes:
        from .nn import dp_group

        if dp_group()[0] is not None:
            raise MXNetError("%s over the batch axis under a data-parallel "
                             "mesh is not ported" % name)


def _check_batch_rows(name, dshape, tshape, reverse):
    """Under a data-parallel mesh of ``n`` ranks, a ``Reshape`` of this
    rank's rows ``dshape`` is the rank's rows of the batch's reshape only
    when the batch's (axis 0 times ``n``) reshapes to the same trailing
    axes and ``n`` times the rows: reshape keeps the row-major order, and
    the rank's rows are one contiguous block of it. Otherwise it raises."""
    from .nn import dp_group

    group, n = dp_group()
    if group is None or not dshape:
        return
    out = _infer_reshape(dshape, tshape, reverse)
    try:
        whole = _infer_reshape((dshape[0] * n,) + tuple(dshape[1:]), tshape,
                               reverse)
    except (IndexError, ValueError, ZeroDivisionError):
        whole = None
    if not out or whole is None or \
            tuple(whole) != (out[0] * n,) + tuple(out[1:]):
        _refuse_batch_axis(name, (0,), len(dshape))


def _reduce(name, fn, aliases=()):
    def _op(data, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, data.dim())
        if exclude and not (axis is None or axis == ()):
            ax = tuple(i for i in range(data.dim()) if i not in ax)
        _refuse_batch_axis(name, ax, data.dim())
        return fn(data, ax, bool(keepdims))

    _op.__name__ = name
    register(name=name, aliases=aliases)(_op)


def _prod(data, ax, keepdims):
    out = data
    for a in sorted(ax, reverse=True):
        out = out.prod(dim=a, keepdim=keepdims)
    return out


_reduce("sum", lambda d, ax, k: d.sum(dim=ax, keepdim=k),
        aliases=("sum_axis",))
_reduce("mean", lambda d, ax, k: d.mean(dim=ax, keepdim=k))
_reduce("prod", _prod)
_reduce("max", lambda d, ax, k: torch.amax(d, dim=ax, keepdim=k),
        aliases=("max_axis",))
_reduce("min", lambda d, ax, k: torch.amin(d, dim=ax, keepdim=k),
        aliases=("min_axis",))


@register(name="norm")
def norm(data, ord=2, axis=None, keepdims=False):
    ax = _norm_axis(axis, data.dim())
    _refuse_batch_axis("norm", ax, data.dim())
    if ord == 1:
        return data.abs().sum(dim=ax, keepdim=bool(keepdims))
    return data.square().sum(dim=ax, keepdim=bool(keepdims)).sqrt()


def _arg_reduce(name, fn):
    def _op(data, axis=None, keepdims=False):
        _refuse_batch_axis(name, _norm_axis(axis, data.dim()), data.dim())
        if axis is None or axis == "None":
            out = fn(data.reshape(-1), 0)
            if keepdims:
                out = out.reshape((1,) * data.dim())
        else:
            out = fn(data, int(axis))
            if keepdims:
                out = out.unsqueeze(int(axis) % data.dim())
        return out.to(torch.float32)

    return _op


register(name="argmax")(_arg_reduce(
    "argmax", lambda d, a: torch.argmax(d, dim=a)))
register(name="argmin")(_arg_reduce(
    "argmin", lambda d, a: torch.argmin(d, dim=a)))


@register(name="broadcast_to")
def broadcast_to(data, shape=()):
    target = tuple(int(s) if int(s) != 0 else int(d)
                   for s, d in zip(shape, data.shape))
    return data.expand(target)


@register(name="broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@register(name="Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False):
    _check_batch_rows("Reshape", tuple(data.shape), tuple(shape), reverse)
    return data.reshape(_infer_reshape(tuple(data.shape), tuple(shape),
                                       reverse))


def _infer_reshape(dshape, tshape, reverse=False):
    """MXNet's reshape codes: 0 copy, -1 infer, -2 copy the rest, -3
    merge two, -4 split one (the JAX package's ``_infer_reshape``)."""
    if not tshape:
        return dshape
    if reverse:
        return _infer_reshape(dshape[::-1], tshape[::-1], False)[::-1]
    out, src, i, j = [], list(dshape), 0, 0
    while j < len(tshape):
        t = int(tshape[j])
        if t > 0:
            out.append(t)
            i += 1
        elif t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            a, b = int(tshape[j + 1]), int(tshape[j + 2])
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        j += 1
    if -1 in out:
        known, total = 1, 1
        for v in out:
            if v != -1:
                known *= v
        for v in dshape:
            total *= v
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register(name="Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register(name="transpose")
def transpose(data, axes=()):
    """``axes`` as in numpy; empty reverses the dims. Returns a view: a
    consumer that needs contiguous memory copies it (the fused conv
    wrapper does)."""
    if not axes:
        axes = tuple(range(data.dim() - 1, -1, -1))
    axes = tuple(int(a) % data.dim() for a in axes)
    if axes and axes[0] != 0:
        _refuse_batch_axis("transpose", (0,), data.dim())
    return data.permute(*axes)


@register(name="expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(int(axis))


@register(name="squeeze")
def squeeze(data, axis=None):
    if axis is None or axis == () or axis == "None":
        return data.squeeze()
    return data.squeeze(_norm_axis(axis, data.dim()))


@register(name="swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    d1, d2 = (int(d) % max(data.dim(), 1) for d in (dim1, dim2))
    if d1 != d2:
        _refuse_batch_axis("swapaxes", (d1, d2), data.dim())
    return data.transpose(d1, d2)


@register(name="dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Contracts the last axis of lhs with the first of rhs; the
    transposes move axis 0 last (lhs) and the last axis first (rhs)."""
    a, b = lhs, rhs
    if transpose_a and a.dim() > 1:
        a = a.permute(*range(1, a.dim()), 0)
    if transpose_b and b.dim() > 1:
        b = b.permute(b.dim() - 1, *range(b.dim() - 1))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


@register(name="batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matrix product over the leading axes; the transposes swap
    each operand's last two axes."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register(name="take")
def take(a, indices, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis`` (indices clipped into range)."""
    ax = int(axis) % a.dim()
    n = a.shape[ax]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if mode != "wrap" else idx.remainder(n)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register(name="Concat", aliases=("concat",))
def concat(*data, dim=1):
    ndim = data[0].dim() if data else 0
    _refuse_batch_axis("Concat", _norm_axis(dim, ndim), ndim)
    return torch.cat(data, dim=int(dim))


@register(name="one_hot")
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
            dtype="float32"):
    hot = F.one_hot(indices.long(), int(depth)).to(dtype_torch(dtype))
    return hot * (on_value - off_value) + off_value
