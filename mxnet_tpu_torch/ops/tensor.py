"""Tensor ops (counterpart of ``mxnet_tpu/ops/tensor.py``, every name of
it): the broadcasting binary, logical and ``_*_scalar`` ops, the unary
math, the reductions, ``Reshape`` (MXNet's special codes), ``Cast``,
``clip``, ``dot``, ``take``, ``Concat``, creation (``_zeros`` ...
``_arange``), slicing and assignment, ``Embedding`` and the other
gathers and scatters, ordering (``topk``, ``sort``, ``argsort``,
``shuffle``), the ``Sequence*`` ops and the ``_linalg_*`` ops (through
``torch.linalg``). Names, input names, attributes, output dtypes and
``nondiff`` are the JAX package's (comparisons and ``argmax`` return the
input's dtype and float32, as there).

Where the JAX package's behaviour is not MXNet's or torch's default, the
port follows the JAX package: an index is clamped into range (negative
ones wrapped first) before it reaches an indexing kernel, and a clamped
gather passes no gradient, as XLA's gather and its transposed scatter do;
``Embedding`` gives a NaN row past the table (``jnp.take``); scatters
drop indices out of range; sorts are stable on every device, so ties come
out in the JAX package's order; ``hypot`` is ``jnp.hypot``'s formula (its
gradient at (0, 0) is (0.5, 0.5)); ``gamma`` is ``exp(gammaln(x))``.

Under a data-parallel mesh (``spmd_scope``) each rank holds its rows of
the batch (axis 0). An op on a batch-leading input (the executor marks
them; called directly, every input counts as one) whose result over those
rows would not be the rank's rows of its result over the whole batch
raises by name (:func:`_refuse_batch_axis`): a ``dot`` that contracts the
batch axis, the reductions (``nansum``, ``nanprod``,
``_square_sum`` and ``cumsum`` too), softmax, log_softmax, argmax and
argmin over axis 0, the sorts along it, ``Concat``, ``stack`` and
``SliceChannel`` on it, a ``transpose`` or ``swapaxes`` that moves it, a
``flip``, ``tile``, ``pad`` or ``slice*`` that reverses, repeats, pads or
cuts it, ``shuffle`` and ``SequenceReverse`` (always axis 0), the
time-major ``SequenceMask``/``SequenceLast``, the nd gathers and scatters
(their indices address axis 0), the matrix ops on a 2-D operand (axis 0
is a matrix axis), ``reshape_like`` and a ``Reshape`` whose output rows
are not the input rows' (:func:`_check_batch_rows`). ``Flatten``, a
``Reshape`` that keeps axis 0 first or merges it with the axes after it,
and ``repeat`` (each row's copies follow it) run as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_torch
from .registry import alias, register


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
    register(name=name, aliases=aliases, nondiff=True)(_op)


_logic("broadcast_equal", torch.eq, aliases=("_equal",))
_logic("broadcast_not_equal", torch.ne, aliases=("_not_equal",))
_logic("broadcast_greater", torch.gt, aliases=("_greater",))
_logic("broadcast_greater_equal", torch.ge, aliases=("_greater_equal",))
_logic("broadcast_lesser", torch.lt, aliases=("_lesser",))
_logic("broadcast_lesser_equal", torch.le, aliases=("_lesser_equal",))
_logic("broadcast_logical_and", torch.logical_and,
       aliases=("_logical_and",))
_logic("broadcast_logical_or", torch.logical_or, aliases=("_logical_or",))
_logic("broadcast_logical_xor", torch.logical_xor,
       aliases=("_logical_xor",))


def _scalar_op(name, fn, aliases=(), nondiff=False):
    def _op(data, scalar=0.0):
        return fn(data, scalar)

    _op.__name__ = name
    register(name=name, aliases=aliases, nondiff=nondiff)(_op)


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
                    ("_lesser_equal_scalar", torch.le),
                    ("_logical_and_scalar", torch.logical_and),
                    ("_logical_or_scalar", torch.logical_or),
                    ("_logical_xor_scalar", torch.logical_xor)):
    _scalar_op(_name, lambda d, s, _c=_cmp: _c(d, d.new_full((), s))
               .to(d.dtype), nondiff=True)


@register(name="_copy", aliases=("identity",))
def _copy(data):
    return data


def _unary(name, fn, aliases=(), nondiff=False):
    def _op(data):
        return fn(data)

    _op.__name__ = name
    register(name=name, aliases=aliases, nondiff=nondiff)(_op)


_unary("relu", lambda data: torch.maximum(data, data.new_zeros(())))
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("negative", lambda data: -data, aliases=("_neg",))
_unary("reciprocal", lambda data: 1.0 / data)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round, nondiff=True)
_unary("rint", torch.round, nondiff=True)
_unary("ceil", torch.ceil, nondiff=True)
_unary("floor", torch.floor, nondiff=True)
_unary("trunc", torch.trunc, nondiff=True)
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


@register(name="zeros_like", nondiff=True)
def zeros_like(data):
    return torch.zeros_like(data)


@register(name="ones_like", nondiff=True)
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
    op over axis 0 with a batch-leading input (:func:`.nn.batch_operand`)
    would see the rank's rows, not the batch, so it raises rather than
    give a rank-local value. Over axis 0 of tensors every rank holds whole
    (weights), it runs."""
    if ndim and 0 in axes:
        from .nn import batch_operand

        if batch_operand():
            raise MXNetError("%s over the batch axis under a data-parallel "
                             "mesh is not ported" % name)


def _check_batch_rows(name, dshape, tshape, reverse):
    """Under a data-parallel mesh of ``n`` ranks, a ``Reshape`` of this
    rank's rows ``dshape`` is the rank's rows of the batch's reshape only
    when the batch's (axis 0 times ``n``) reshapes to the same trailing
    axes and ``n`` times the rows: reshape keeps the row-major order, and
    the rank's rows are one contiguous block of it. Otherwise it raises."""
    from .nn import batch_operand, dp_group

    group, n = dp_group()
    if group is None or not dshape or not batch_operand(0):
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


register(name="argmax", nondiff=True)(_arg_reduce(
    "argmax", lambda d, a: torch.argmax(d, dim=a)))
register(name="argmin", nondiff=True)(_arg_reduce(
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
    transposes move axis 0 last (lhs) and the last axis first (rhs).
    Under a data-parallel mesh a contraction of a batch-leading operand's
    axis 0 would sum the rank's rows only, so it raises: ``lhs`` with
    ``transpose_a`` (or 1-D), and, where the executor marks it
    batch-leading, ``rhs`` without ``transpose_b`` (or 1-D). Called
    outside an executor, the ``lhs`` counts as batch-leading and the
    ``rhs`` as a weight."""
    from .nn import batch_operand

    if (transpose_a or lhs.dim() == 1) and batch_operand(0):
        raise MXNetError("dot(transpose_a=%s) contracts the batch axis of "
                         "its lhs under a data-parallel mesh: not ported"
                         % bool(transpose_a))
    if (not transpose_b or rhs.dim() == 1) and \
            batch_operand(1, unmarked=False):
        raise MXNetError("dot(transpose_b=%s) contracts the batch axis of "
                         "its rhs under a data-parallel mesh: not ported"
                         % bool(transpose_b))
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


@register(name="one_hot", nondiff=True)
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
            dtype="float32"):
    hot = F.one_hot(indices.long(), int(depth)).to(dtype_torch(dtype))
    return hot * (on_value - off_value) + off_value


# ---------------------------------------------------------------------------
# Queue A item 7b: the rest of mxnet_tpu/ops/tensor.py
# ---------------------------------------------------------------------------
def _math(name, fn, nondiff=False):
    """A unary op the JAX package registers as a ``jax.numpy``/``jax.scipy``
    function: its one input is named ``x`` there, so it is here too."""
    def _op(x):
        return fn(x)

    _op.__name__ = name
    register(name=name, nondiff=nondiff)(_op)


def _cbrt(x):
    """The real cube root (torch has no ``cbrt``): the sign times the cube
    root of the magnitude, whose gradient is ``1 / (3 cbrt(x)^2)`` as
    ``jnp.cbrt``'s."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


for _name, _fn in (
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("arcsin", torch.asin), ("arccos", torch.acos),
        ("arctan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
        ("arctanh", torch.atanh), ("degrees", torch.rad2deg),
        ("radians", torch.deg2rad), ("log10", torch.log10),
        ("log2", torch.log2), ("log1p", torch.log1p),
        ("expm1", torch.expm1), ("cbrt", _cbrt), ("gammaln", torch.lgamma),
        ("erf", torch.erf), ("erfinv", torch.erfinv),
        ("softsign", lambda x: x / (x.abs() + 1))):
    _math(_name, _fn)
_math("fix", torch.trunc, nondiff=True)
# gamma is exp(gammaln(x)) there: |Gamma(x)|, so gamma(-0.5) is +3.5449
_unary("gamma", lambda data: torch.exp(torch.lgamma(data)))
_unary("rcbrt", lambda data: 1.0 / _cbrt(data))
_unary("logical_not", lambda data: (data == 0).to(data.dtype), nondiff=True)


def _abs(x):
    """``|x|`` whose gradient at 0 is 1, as ``jnp.abs``'s."""
    return torch.where(x >= 0, x, -x)


def _hypot(x1, x2):
    """``jnp.hypot``'s formula: ``max * sqrt(1 + (min / max)^2)``, 0 where
    both are 0 and inf where either is; so the gradient at (0, 0) is
    (0.5, 0.5), the tie of ``maximum``, where ``torch.hypot`` gives NaN."""
    a, b = _abs(x1), _abs(x2)
    inf = torch.isposinf(a) | torch.isposinf(b)
    big, small = torch.maximum(a, b), torch.minimum(a, b)
    zero = big == 0
    ratio = small / torch.where(zero, torch.ones_like(big), big)
    out = torch.where(zero, big, big * torch.sqrt(1 + ratio * ratio))
    return torch.where(inf, torch.full_like(out, float("inf")), out)


register(name="broadcast_hypot", aliases=("_hypot",))(_hypot)
_scalar_op("_hypot_scalar", lambda d, s: _hypot(d, d.new_full((), s)))


@register(name="_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


@register(name="add_n", aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    """The sum of N tensors, added left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register(name="where")
def where(condition, x, y):
    """``x`` where ``condition`` is nonzero, else ``y``; a 1-D condition
    picks whole rows of a higher-rank ``x``."""
    if condition.dim() == 1 and x.dim() > 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)


@register(name="smooth_l1")
def smooth_l1(data, scalar=1.0):
    """``0.5 (s x)^2`` where ``|x| < 1 / s^2``, else ``|x| - 0.5 / s^2``."""
    s2 = scalar * scalar
    ax = data.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * data * data * s2, ax - 0.5 / s2)


@register(name="_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register(name="_CrossDeviceCopy")
def _cross_device_copy(data):
    """Identity: a tensor's device is its placement."""
    return data


@register(name="_square_sum")
def _square_sum(data, axis=None, keepdims=False, exclude=False):
    """``sum(data ** 2)`` over ``axis``; ``exclude`` is accepted and
    ignored, as the JAX package does."""
    ax = _norm_axis(axis, data.dim())
    _refuse_batch_axis("_square_sum", ax, data.dim())
    return (data * data).sum(dim=ax, keepdim=bool(keepdims))


@register(name="cast_storage", nondiff=True)
def cast_storage(data, stype="default"):
    """The dense fallback: the identity, whatever ``stype``. The sparse
    form is ``ndarray/sparse.py``'s ``cast_storage``, which
    ``NDArray.tostype`` and ``mx.nd.cast_storage`` take for a sparse
    ``stype``, as the JAX package converts in its NDArray front end."""
    return data


def _index(indices):
    """Index values as the JAX package's ``astype(int32)``: truncated
    toward zero."""
    return indices.long()


def _wrap(idx, n):
    """Negative indices count from the end (numpy's normalisation)."""
    return torch.where(idx < 0, idx + n, idx)


def _clamped(idx, n):
    """``(index, in range)`` of a gather index as ``jnp`` indexing reads it:
    negative ones wrap, then every one is clamped into ``[0, n)`` (an XLA
    gather's). Clamped before indexing, so an index out of range never
    reaches the card (a device assert)."""
    idx = _wrap(idx, n)
    return idx.clamp(0, max(n - 1, 0)), (idx >= 0) & (idx < n)


def _drop_grad(out, valid):
    """``out`` with no gradient through the rows where ``valid`` (over its
    leading axes) is false: the transpose of an XLA gather is a scatter,
    which drops what was out of range."""
    if not out.requires_grad:
        return out
    v = valid.reshape(tuple(valid.shape) + (1,) * (out.dim() - valid.dim()))
    return torch.where(v, out, out.detach())


@register(name="_sparse_retain", nondiff=True)
def _sparse_retain(data, indices):
    """The dense fallback of row-sparse retain: rows not in ``indices``
    become 0 (negative indices wrap; out of range ones are dropped, as a
    JAX scatter drops them). A row-sparse ``data`` takes the sparse form,
    ``ndarray/sparse.py``'s ``retain_rows``, through ``mx.nd``."""
    n = data.shape[0]
    idx = _wrap(_index(indices).reshape(-1), n)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    keep = data.new_zeros(n + 1).index_fill(0, idx, 1)[:n] != 0
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       data.new_zeros(()))


# ---------------------------------------------------------------------------
# creation: on the device the caller makes the default (``invoke`` uses the
# op's context, the executor the graph's, shape inference ``meta``)
# ---------------------------------------------------------------------------
@register(name="_zeros", nondiff=True)
def _zeros(shape=(), ctx=None, dtype="float32"):
    return torch.zeros(_shape_of(shape), dtype=dtype_torch(dtype))


@register(name="_ones", nondiff=True)
def _ones(shape=(), ctx=None, dtype="float32"):
    return torch.ones(_shape_of(shape), dtype=dtype_torch(dtype))


@register(name="_full", nondiff=True)
def _full(shape=(), value=0.0, ctx=None, dtype="float32"):
    return torch.full(_shape_of(shape), value, dtype=dtype_torch(dtype))


@register(name="_eye", nondiff=True)
def _eye(N=0, M=0, k=0, ctx=None, dtype="float32"):
    """Ones on the ``k``-th diagonal of an ``N x M`` matrix; ``M=0`` means
    ``M = N``, as in the JAX package."""
    n, m = int(N), int(M) if M else int(N)
    rows = torch.arange(n).unsqueeze(1)
    return (torch.arange(m).unsqueeze(0) - rows == int(k)) \
        .to(dtype_torch(dtype))


@register(name="_arange", nondiff=True)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype="float32"):
    """``arange(start, stop, step)``; ``stop=None`` is ``range(start)``,
    as numpy's; each value ``repeat`` times."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype))
    if int(repeat) != 1:
        out = out.repeat_interleave(int(repeat))
    return out


def _shape_of(shape):
    return (int(shape),) if isinstance(shape, (int, float)) else \
        tuple(int(s) for s in shape)


# ---------------------------------------------------------------------------
# shape and indexing
# ---------------------------------------------------------------------------
def _opt_int(v):
    return None if v is None or v == "None" else int(v)


def _slices(name, shape, begin, end, step):
    """``(slices, flipped)`` for ``data[begin:end:step]`` over the leading
    axes, every slice with a positive step: an axis with a negative step is
    flipped first (``flipped``), and its slice reads the flipped axis in
    the same order. Under a data-parallel mesh a slice that cuts axis 0
    raises."""
    step = tuple(step) if step else (None,) * len(begin)
    out, flipped = [], []
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        b, e, s = _opt_int(b), _opt_int(e), _opt_int(s)
        if ax == 0 and (b not in (None, 0) or e is not None
                        or s not in (None, 1)):
            _refuse_batch_axis(name, (0,), len(shape))
        if s is None or s > 0:
            out.append(slice(b, e, s))
            continue
        picked = range(*slice(b, e, s).indices(shape[ax]))
        q = shape[ax] - 1 - picked.start
        out.append(slice(q, q + len(picked) * -s, -s))
        flipped.append(ax)
    return tuple(out), tuple(flipped)


@register(name="slice")
def slice_op(data, begin=(), end=(), step=()):
    """``data[begin:end:step]`` over the leading ``len(begin)`` axes
    (``None`` entries open, negative steps as numpy's)."""
    sl, flipped = _slices("slice", tuple(data.shape), begin, end, step)
    return (data.flip(flipped) if flipped else data)[sl]


@register(name="slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    ax = int(axis) % data.dim()
    e = _opt_int(end)
    if ax == 0 and (int(begin) != 0 or e is not None):
        _refuse_batch_axis("slice_axis", (0,), data.dim())
    idx = [slice(None)] * data.dim()
    idx[ax] = slice(int(begin), e)
    return data[tuple(idx)]


@register(name="slice_like")
def slice_like(data, shape_like, axes=()):
    """``data`` cut to ``shape_like``'s size on ``axes`` (all of its axes
    by default), from the start."""
    axes_ = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes_:
        a = int(a)
        if a % data.dim() == 0 and shape_like.shape[a] != data.shape[a]:
            _refuse_batch_axis("slice_like", (0,), data.dim())
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


def _assign(name, lhs, value, begin, end, step):
    sl, flipped = _slices(name, tuple(lhs.shape), begin, end, step)
    out = lhs.flip(flipped) if flipped else lhs.clone()
    out[sl] = value
    return out.flip(flipped) if flipped else out


@register(name="_slice_assign")
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with ``lhs[begin:end:step] = rhs`` (a new tensor)."""
    return _assign("_slice_assign", lhs, rhs, begin, end, step)


@register(name="_slice_assign_scalar")
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    return _assign("_slice_assign_scalar", data, scalar, begin, end, step)


@register(name="tile")
def tile(data, reps=()):
    """numpy's ``tile``: more reps than axes prepend axes (the batch then
    no longer leads), fewer tile the trailing axes."""
    reps = tuple(int(r) for r in reps)
    if len(reps) > data.dim() or (len(reps) == data.dim() and reps
                                  and reps[0] != 1):
        _refuse_batch_axis("tile", (0,), data.dim())
    return data.tile(reps)


@register(name="repeat")
def repeat(data, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (``None``: of the
    flattened array). Each row's copies follow it, so a rank's rows of the
    batch give its rows of the result: no batch-axis guard."""
    if axis is None or axis == "None":
        return data.reshape(-1).repeat_interleave(int(repeats))
    return data.repeat_interleave(int(repeats), dim=int(axis))


@register(name="pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """numpy's ``pad`` with ``pad_width`` flat ``(before, after)`` pairs from
    axis 0; modes ``constant``, ``edge`` and ``reflect`` (numpy's, without
    the edge repeated, for any width)."""
    pw = tuple(int(p) for p in pad_width)
    pairs = [(pw[i], pw[i + 1]) for i in range(0, len(pw), 2)]
    if pairs and pairs[0] != (0, 0):
        _refuse_batch_axis("pad", (0,), data.dim())
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise MXNetError("pad: unknown mode %r (constant, edge or reflect)"
                         % (mode,))
    out = data
    for ax, (lo, hi) in enumerate(pairs):
        if not lo and not hi:
            continue
        n = out.shape[ax]
        pos = torch.arange(-lo, n + hi, device=out.device)
        if mode == "edge" or n == 1:
            pos = pos.clamp(0, n - 1)
        else:
            period = 2 * (n - 1)
            pos = pos.abs() % period
            pos = torch.where(pos >= n, period - pos, pos)
        out = out.index_select(ax, pos)
    return out


@register(name="flip", aliases=("reverse",))
def flip(data, axis=()):
    ax = _norm_axis(axis, data.dim()) if axis != () else ()
    _refuse_batch_axis("flip", ax, data.dim())
    return data.flip(ax)


@register(name="stack")
def stack(*args, num_args=None, axis=0):
    """The inputs stacked on a new ``axis``: on axis 0 the batch no longer
    leads."""
    ndim = args[0].dim() + 1 if args else 0
    _refuse_batch_axis("stack", _norm_axis(axis, ndim), ndim)
    return torch.stack(args, dim=int(axis))


def _n_split(attrs):
    return int(attrs.get("num_outputs", 1))


@register(name="SliceChannel", aliases=("slice_channel", "split"),
          num_outputs=_n_split)
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts of ``axis`` (which must divide it),
    each with that axis dropped under ``squeeze_axis``."""
    ax, n = int(axis) % data.dim(), int(num_outputs)
    _refuse_batch_axis("SliceChannel", (ax,), data.dim())
    if data.shape[ax] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d" % (ax, data.shape[ax], n))
    parts = data.split(data.shape[ax] // n, dim=ax)
    if squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register(name="space_to_depth")
def space_to_depth(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register(name="depth_to_space")
def depth_to_space(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register(name="reshape_like")
def reshape_like(lhs, rhs):
    """``lhs`` in ``rhs``'s shape. Under a data-parallel mesh ``rhs``'s shape
    is checked as a ``Reshape``'s literal target: a rank cannot tell
    whether ``rhs`` is batch-leading, so it raises."""
    _check_batch_rows("reshape_like", tuple(lhs.shape), tuple(rhs.shape),
                      False)
    return lhs.reshape(rhs.shape)


@register(name="broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    target = list(data.shape)
    for a, s in zip(axes, sizes):
        target[int(a)] = int(s)
    return data.expand(tuple(target))


def _refuse_matrix(name, a):
    """Axis 0 of a matrix (or a vector) is one of its matrix axes."""
    if a.dim() <= 2:
        _refuse_batch_axis(name, (0,), a.dim())


@register(name="diag")
def diag(data, k=0):
    """The diagonal matrix of a vector, or the ``k``-th diagonal of the
    last two axes."""
    _refuse_matrix("diag", data)
    if data.dim() == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=-2, dim2=-1)


@register(name="khatri_rao")
def khatri_rao(*args, num_args=None):
    """The column-wise Khatri-Rao product of the matrices."""
    for a in args:
        _refuse_matrix("khatri_rao", a)
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


@register(name="batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` a row (indices wrapped and clamped)."""
    idx, valid = _clamped(_index(indices), a.shape[1])
    return _drop_grad(a[torch.arange(a.shape[0], device=a.device), idx],
                      valid)


@register(name="Embedding")
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` as ``jnp.take`` reads them: an index truncated to
    an integer, a negative one counted from the end, and one out of range
    a row of NaN (MXNet would clip). ``dtype`` and ``sparse_grad`` are
    accepted, as in the JAX package (dense gradients)."""
    n = weight.shape[0]
    idx = _wrap(_index(data), n)
    valid = (idx >= 0) & (idx < n)
    rows = F.embedding(torch.where(valid, idx, 0), weight)
    return torch.where(valid.unsqueeze(-1), rows,
                       rows.new_full((), float("nan")))


def _nd_index(name, indices, shape):
    """The index tensors of ``indices`` (M, ...) into the leading M axes
    of ``shape``, negative ones wrapped (they address axis 0: raises under
    a data-parallel mesh)."""
    _refuse_batch_axis(name, (0,), len(shape))
    idx = _index(indices)
    return [_wrap(idx[i], shape[i]) for i in range(idx.shape[0])]


@register(name="gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]`` with each index clamped
    into its axis (a JAX gather's)."""
    idx = _nd_index("gather_nd", indices, tuple(data.shape))
    clamped = [_clamped(i, data.shape[a]) for a, i in enumerate(idx)]
    valid = clamped[0][1]
    for _i, v in clamped[1:]:
        valid = valid & v
    return _drop_grad(data[tuple(i for i, _v in clamped)], valid)


def _flat_rows(idx, shape):
    """Row numbers of the index tuples in the leading axes of ``shape``
    flattened; a tuple out of range gets the row past the end (its update
    is dropped, as a JAX scatter drops it)."""
    lead = 1
    for s in shape[:len(idx)]:
        lead *= s
    row = torch.zeros_like(idx[0])
    valid = torch.ones_like(idx[0], dtype=torch.bool)
    for i, s in zip(idx, shape):
        valid &= (i >= 0) & (i < s)
        row = row * s + i
    return torch.where(valid, row, lead).reshape(-1), lead


@register(name="scatter_nd")
def scatter_nd(data, indices, shape=()):
    """A zero tensor of ``shape`` with ``data`` added at ``indices``."""
    shape = _shape_of(shape)
    idx = _nd_index("scatter_nd", indices, shape)
    rows, lead = _flat_rows(idx, shape)
    rest = shape[len(idx):]
    out = data.new_zeros((lead + 1,) + rest)
    out = out.index_add(0, rows, data.reshape((-1,) + rest))
    return out[:lead].reshape(shape)


@register(name="_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    """``lhs`` with ``rhs`` set at ``indices`` (a new tensor)."""
    idx = _nd_index("_scatter_set_nd", indices, tuple(lhs.shape))
    rows, lead = _flat_rows(idx, tuple(lhs.shape))
    rest = tuple(lhs.shape[len(idx):])
    src = rhs.to(lhs.dtype).expand(tuple(idx[0].shape) + rest) \
        .reshape((-1,) + rest)
    buf = torch.cat([lhs.reshape((lead,) + rest),
                     lhs.new_zeros((1,) + rest)])
    return buf.index_copy(0, rows, src)[:lead].reshape(lhs.shape)


@register(name="pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s element at ``index`` along ``axis`` (clipped into range:
    ``mode`` is accepted and ignored, as in the JAX package)."""
    ax = data.dim() - 1 if axis in (None, "None") else int(axis) % data.dim()
    _refuse_batch_axis("pick", (ax,), data.dim())
    idx = _index(index).clamp(0, data.shape[ax] - 1)
    if idx.dim() < data.dim():
        idx = idx.unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


@register(name="cumsum")
def cumsum(a, axis=None, dtype=None):
    """The running sum along ``axis`` (``None``: of the flattened array)."""
    dt = None if dtype is None else dtype_torch(dtype)
    if axis is None or axis == "None":
        _refuse_batch_axis("cumsum", (0,), a.dim())
        return torch.cumsum(a.reshape(-1), 0, dtype=dt)
    ax = int(axis) % max(a.dim(), 1)
    _refuse_batch_axis("cumsum", (ax,), a.dim())
    return torch.cumsum(a, ax, dtype=dt)


_reduce("nansum", lambda d, ax, k: torch.where(
    torch.isnan(d), torch.zeros_like(d), d).sum(dim=ax, keepdim=k))
_reduce("nanprod", lambda d, ax, k: _prod(torch.where(
    torch.isnan(d), torch.ones_like(d), d), ax, k))


@register(name="argmax_channel", nondiff=True)
def argmax_channel(data):
    _refuse_batch_axis("argmax_channel", (data.dim() - 1,), data.dim())
    return torch.argmax(data, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# ordering: stable sorts on every device, so ties come out in the JAX
# package's order (torch.topk promises none)
# ---------------------------------------------------------------------------
def _sort_axis(name, data, axis):
    ax = data.dim() - 1 if axis in (None, "None") else int(axis) % data.dim()
    _refuse_batch_axis(name, (ax,), data.dim())
    return ax


def _n_topk(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register(name="topk", nondiff=True, num_outputs=_n_topk)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis`` by a
    stable sort of ``-x`` (``x``): of tied values the first index comes
    first. ``ret_typ``: ``value``, ``indices`` (as ``dtype``), ``mask`` or
    ``both`` (values, indices); ``k <= 0`` takes the whole axis."""
    ax = _sort_axis("topk", data, axis)
    x = data.movedim(ax, -1)
    k = int(k) if int(k) > 0 else x.shape[-1]
    idx = torch.argsort(x if is_ascend else -x, dim=-1, stable=True)[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(x).scatter(-1, idx, 1.0)
        return mask.movedim(-1, ax)
    vals = torch.gather(x, -1, idx).movedim(-1, ax)
    idxf = idx.to(dtype_torch(dtype)).movedim(-1, ax)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxf
    return vals, idxf


@register(name="sort")
def sort(data, axis=-1, is_ascend=True):
    """A stable ascending sort, flipped for descending (so of tied values
    the gradient goes where the JAX package sends it)."""
    ax = _sort_axis("sort", data, axis)
    out = torch.sort(data, dim=ax, stable=True).values
    return out if is_ascend else out.flip(ax)


@register(name="argsort", nondiff=True)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """A stable ascending argsort, flipped for descending: of tied values
    the last index comes first there, as in the JAX package."""
    ax = _sort_axis("argsort", data, axis)
    idx = torch.argsort(data, dim=ax, stable=True)
    if not is_ascend:
        idx = idx.flip(ax)
    return idx.to(dtype_torch(dtype))


@register(name="shuffle", aliases=("_shuffle",), needs_rng=True,
          nondiff=True)
def shuffle(gen, data):
    """The rows of ``data`` (axis 0) in a random order drawn from ``gen``
    (not threefry's order: held by distribution)."""
    _refuse_batch_axis("shuffle", (0,), data.dim())
    if gen is None:                      # meta tensors: shapes only
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]


# ---------------------------------------------------------------------------
# sequence ops: time-major (T, B, ...) with axis=0; SequenceMask and
# SequenceLast also take batch-major (B, T, ...) with axis=1
# ---------------------------------------------------------------------------
def _refuse_time_major(name, axis, ndim):
    """With ``axis=0`` the batch is axis 1 and axis 0 is time, which a
    data-parallel rank holds only its rows of (as for ``RNN``)."""
    if int(axis) == 0:
        _refuse_batch_axis(name, (0,), ndim)


@register(name="SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at the steps at or past each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    _refuse_time_major("SequenceMask", axis, data.dim())
    steps = torch.arange(data.shape[int(axis)], device=data.device)
    mask = steps.unsqueeze(1) < _index(sequence_length).unsqueeze(0)
    if int(axis) == 1:
        mask = mask.t()
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, data.new_full((), value))


@register(name="SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """The last step of each sequence: step ``length - 1``, so a length of
    0 wraps to the last step, as in the JAX package."""
    ax = int(axis)
    _refuse_time_major("SequenceLast", ax, data.dim())
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, -1)
    x = data.movedim(ax, 0)
    last, valid = _clamped(_index(sequence_length) - 1, x.shape[0])
    return _drop_grad(x[last, torch.arange(x.shape[1], device=x.device)],
                      valid)


@register(name="SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed in place. Always on
    axis 0 (time-major; ``axis`` is accepted and ignored, as in the JAX
    package)."""
    _refuse_batch_axis("SequenceReverse", (0,), data.dim())
    if not use_sequence_length or sequence_length is None:
        return data.flip(0)
    t = data.shape[0]
    steps = torch.arange(t, device=data.device).unsqueeze(1)
    lens = _index(sequence_length).unsqueeze(0)
    src, valid = _clamped(torch.where(steps < lens, lens - 1 - steps,
                                      steps), t)
    return _drop_grad(
        data[src, torch.arange(data.shape[1], device=data.device)], valid)


# ---------------------------------------------------------------------------
# linear algebra (torch.linalg: cuSOLVER/cuBLAS on the card); a 2-D operand's
# axis 0 is a matrix axis, which a data-parallel rank holds only rows of
# ---------------------------------------------------------------------------
def _mt(a, flag=True):
    return a.transpose(-1, -2) if flag else a


@register(name="_linalg_gemm")
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    """``alpha op(A) op(B) + beta C`` (``axis`` accepted and ignored)."""
    _refuse_matrix("_linalg_gemm", A)
    return alpha * torch.matmul(_mt(A, transpose_a), _mt(B, transpose_b)) \
        + beta * C


@register(name="_linalg_gemm2")
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    _refuse_matrix("_linalg_gemm2", A)
    return alpha * torch.matmul(_mt(A, transpose_a), _mt(B, transpose_b))


@register(name="_linalg_potrf")
def _linalg_potrf(A):
    """The lower Cholesky factor."""
    _refuse_matrix("_linalg_potrf", A)
    return torch.linalg.cholesky(A)


@register(name="_linalg_potri")
def _linalg_potri(A):
    """``inv(A)^T inv(A)``: the inverse of ``L L^T`` from its factor."""
    _refuse_matrix("_linalg_potri", A)
    inv = torch.linalg.inv(A)
    return torch.matmul(_mt(inv), inv)


@register(name="_linalg_trmm")
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """``alpha op(A) B`` (or ``B op(A)``) with the whole of ``A``: ``lower``
    is accepted and ignored, as in the JAX package."""
    _refuse_matrix("_linalg_trmm", A)
    a = _mt(A, transpose)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


def _solve_tri(a, b, lower, trans):
    """``solve_triangular(a, b, trans, lower)`` as the JAX package calls it:
    only ``a``'s ``lower`` (or upper) triangle is read."""
    t = torch.tril(a) if lower else torch.triu(a)
    if trans:
        return torch.linalg.solve_triangular(_mt(t), b, upper=bool(lower))
    return torch.linalg.solve_triangular(t, b, upper=not lower)


@register(name="_linalg_trsm")
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """``X`` with ``op(A) X = alpha B`` (or ``X op(A) = alpha B``). The
    right-side form solves ``A^T X^T = alpha B^T`` with ``lower`` passed on
    unchanged for ``A^T``, as the JAX package does (so of a lower ``A`` it
    reads the diagonal)."""
    _refuse_matrix("_linalg_trsm", A)
    if rightside:
        return _mt(_solve_tri(_mt(A), _mt(alpha * B), lower, transpose))
    return _solve_tri(A, alpha * B, lower, transpose)


@register(name="_linalg_syrk")
def _linalg_syrk(A, transpose=False, alpha=1.0):
    _refuse_matrix("_linalg_syrk", A)
    a = _mt(A, transpose)
    return alpha * torch.matmul(a, _mt(a))


@register(name="_linalg_sumlogdiag")
def _linalg_sumlogdiag(A):
    _refuse_matrix("_linalg_sumlogdiag", A)
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register(name="_linalg_syevd", num_outputs=2)
def _linalg_syevd(A):
    """``(U, w)``: the eigenvectors as rows and the ascending eigenvalues
    of ``(A + A^T) / 2`` (``jnp.linalg.eigh`` symmetrises its input). A
    row is unique only up to its sign."""
    _refuse_matrix("_linalg_syevd", A)
    w, v = torch.linalg.eigh((A + _mt(A)) / 2)
    return _mt(v), w


@register(name="_linalg_gelqf", num_outputs=2)
def _linalg_gelqf(A):
    """``(L, Q)`` with ``A = L Q`` and ``Q``'s rows orthonormal, from the QR
    factors of ``A^T`` (unique up to the signs of Q's rows)."""
    _refuse_matrix("_linalg_gelqf", A)
    q, r = torch.linalg.qr(_mt(A), mode="reduced")
    return _mt(r), _mt(q)


@register(name="_linalg_extractdiag")
def _linalg_extractdiag(A, offset=0):
    _refuse_matrix("_linalg_extractdiag", A)
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register(name="_linalg_makediag")
def _linalg_makediag(A, offset=0):
    """Square matrices with the last axis on their ``offset`` diagonal."""
    _refuse_matrix("_linalg_makediag", A)
    return torch.diag_embed(A, offset=int(offset))


@register(name="_linalg_extracttrian")
def _linalg_extracttrian(A, offset=0, lower=True):
    """The lower (or upper) triangle from the ``offset`` diagonal, row by
    row, as a vector a matrix."""
    _refuse_matrix("_linalg_extracttrian", A)
    n = A.shape[-1]
    make = torch.tril_indices if lower else torch.triu_indices
    rows, cols = make(n, n, int(offset), device=A.device)
    return A[..., rows, cols]


alias("_grad_add", "broadcast_add")
alias("_scatter_plus_scalar", "_plus_scalar")
alias("_scatter_minus_scalar", "_minus_scalar")
alias("_contrib_SparseEmbedding", "Embedding")
