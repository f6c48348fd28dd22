"""NDArray — the imperative array (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

An ``NDArray`` is a handle over one ``torch.Tensor`` on its context (its
``tensor``). Operators go through :func:`invoke`, which calls the
registered op on the tensors, under autograd only inside
``autograd.record()``. In-place operators and ``__setitem__`` write into
the tensor itself, so every holder of the handle, an executor's
``arg_dict`` included, sees the new values. Basic indexing (ints, slices,
``Ellipsis``, ``None``) returns a view that shares the parent's memory,
so writes through it reach the parent, as the JAX package's
``_base``/``_index`` views do; an index array gathers a copy.

``dtype`` is a numpy scalar type, except bfloat16, which numpy lacks:
there it is ``torch.bfloat16``, and ``asnumpy()`` gives float32 (exact).
Not ported: sparse storage (``tostype`` to csr/row_sparse raises), and
ops the registry does not hold (their methods raise naming the op).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _ag
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import Context, current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "waitall", "invoke"]

_NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.uint8: np.uint8,
             torch.int8: np.int8, torch.int32: np.int32,
             torch.int64: np.int64, torch.bool: np.bool_}


def _basic_key(key):
    """Whether ``key`` indexes without gathering (a view)."""
    parts = key if isinstance(key, tuple) else (key,)
    return all(k is None or k is Ellipsis or isinstance(k, slice)
               or (isinstance(k, (int, np.integer))
                   and not isinstance(k, bool)) for k in parts)


class NDArray:
    """A multi-dimensional array on a device context."""

    __slots__ = ("_t", "_ctx", "_grad", "_grad_req", "__weakref__")

    # numpy defers binary ops to us
    __array_priority__ = 100.0

    def __init__(self, tensor, ctx=None):
        if not isinstance(tensor, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %r"
                             % type(tensor))
        self._t = tensor
        self._ctx = ctx if ctx is not None else \
            Context.from_device(tensor.device)
        self._grad = None
        self._grad_req = "null"

    # -- value access --------------------------------------------------------
    @property
    def tensor(self):
        """The ``torch.Tensor`` this handle holds."""
        return self._t

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def size(self):
        return self._t.numel()

    @property
    def dtype(self):
        return _NP_TYPES.get(self._t.dtype, self._t.dtype)

    @property
    def stype(self):
        return "default"

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def grad(self):
        return self._grad

    def wait_to_read(self):
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy of the values (bfloat16 as float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return "\n%s\n<%s %s @%s>" % (
            self.asnumpy(), type(self).__name__,
            "x".join(str(s) for s in self.shape), self._ctx)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __hash__(self):
        return id(self)

    # -- dtype / context movement --------------------------------------------
    def astype(self, dtype, copy=True):
        if dtype_name(self._t.dtype) == dtype_name(dtype) and not copy:
            return self
        return invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def copy(self):
        return NDArray(self._t.detach().clone(), self._ctx)

    def copyto(self, other):
        """Copy into another NDArray (in place, cast to its dtype) or to a
        context (a new array)."""
        if isinstance(other, Context):
            return NDArray(self._t.detach().to(other.torch_device(),
                                               copy=True), other)
        if isinstance(other, NDArray):
            if other._t is not self._t:
                with torch.no_grad():
                    other._t.copy_(self._t.detach().reshape(other.shape))
            return other
        raise MXNetError("copyto: unsupported target %r" % (other,))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    def detach(self):
        return NDArray(self._t.detach(), self._ctx)

    def tostype(self, stype):
        if stype == "default":
            return self
        raise MXNetError("NDArray.tostype(%r): sparse storage is not "
                         "ported" % (stype,))

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array an autograd variable with a zero gradient
        buffer (``.grad``)."""
        if stype not in (None, "default"):
            raise MXNetError("attach_grad(stype=%r): sparse gradients are "
                             "not ported" % (stype,))
        _ag.mark_variables([self], [zeros_like(self)], grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], None if out_grad is None else [out_grad],
                     retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._t
        elif isinstance(key, (np.ndarray, list)):
            key = torch.as_tensor(np.asarray(key), device=self._t.device)
        if isinstance(key, torch.Tensor):
            if key.dtype != torch.bool:
                key = key.long()
            return self._wrap(self._t[key])
        if not _basic_key(key):
            raise MXNetError("NDArray index %r is not supported" % (key,))
        return self._wrap(self._t[key])

    def __setitem__(self, key, value):
        if isinstance(key, NDArray):
            key = key._t
            key = key if key.dtype == torch.bool else key.long()
        if isinstance(value, NDArray):
            value = value._t.detach()
        elif not isinstance(value, (int, float, bool)):
            value = torch.from_numpy(np.array(value))
        if isinstance(value, torch.Tensor):
            value = value.to(device=self._t.device, dtype=self._t.dtype)
        with torch.no_grad():
            self._t[key] = value

    def _wrap(self, t):
        return NDArray(t, self._ctx)

    # -- shape methods -------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return invoke("Reshape", [self], {
            "shape": shape, "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    @property
    def T(self):
        return invoke("transpose", [self], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def flatten(self):
        return invoke("Flatten", [self], {})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return invoke("one_hot", [self], {
            "depth": depth, "on_value": on_value, "off_value": off_value,
            "dtype": dtype})

    # -- reductions ----------------------------------------------------------
    def _reduce(self, op, axis, keepdims):
        return invoke(op, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    # -- elementwise ---------------------------------------------------------
    def _unary(self, op):
        return invoke(op, [self], {})

    def abs(self):
        return self._unary("abs")

    def sign(self):
        return self._unary("sign")

    def square(self):
        return self._unary("square")

    def sqrt(self):
        return self._unary("sqrt")

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def relu(self):
        return self._unary("relu")

    def sigmoid(self):
        return self._unary("sigmoid")

    def tanh(self):
        return self._unary("tanh")

    def round(self):
        return self._unary("round")

    def floor(self):
        return self._unary("floor")

    def ceil(self):
        return self._unary("ceil")

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, (np.ndarray, list)):
            other = array(other, ctx=self._ctx)
        if isinstance(other, NDArray):
            return invoke(op, [other, self] if reverse else [self, other], {})
        if isinstance(other, (int, float, np.generic)):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", "_rdiv_scalar",
                           reverse=True)

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binop(other, "broadcast_mod", "_rmod_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binop(other, "broadcast_power", "_rpower_scalar",
                           reverse=True)

    def __neg__(self):
        return self._unary("negative")

    def __abs__(self):
        return self._unary("abs")

    def __eq__(self, other):
        if other is None:
            return False
        return self._binop(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop(other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    # in place: the result is written into this array's own tensor (cast to
    # its dtype), so every holder of the handle sees it
    def _inplace(self, result):
        if result is NotImplemented:
            return result
        with torch.no_grad():
            self._t.copy_(result._t)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))


def invoke(op, inputs, attrs, out=None, ctx=None):
    """Call a registered op on NDArrays (the imperative invoke): parse the
    attributes, thread ``__is_train__`` from ``autograd.is_training()``,
    run the op under autograd only while recording, and wrap the visible
    outputs; ``out`` receives them in place. A random op draws from the
    context's ``random.generator`` (so its backward, recorded by torch,
    uses the forward's draw)."""
    if isinstance(op, str):
        try:
            op = _reg.get(op)
        except MXNetError:
            raise MXNetError("operator %r is not ported" % op) from None
    attrs = {k: v for k, v in attrs.items()
             if v is not None or k in ("axis", "dtype")}
    attrs.pop("name", None)
    parsed = op.parse_attrs(attrs)
    if "__is_train__" in op.attr_defaults:
        parsed["__is_train__"] = _ag.is_training()
    tensors = [x._t if isinstance(x, NDArray) else x for x in inputs]
    ctx = ctx or next((x._ctx for x in inputs if isinstance(x, NDArray)),
                      None) or current_context()
    if op.needs_rng:
        # the context's stream, as the JAX package's next_key(ctx)
        from .. import random as _random

        tensors = [_random.generator(ctx)] + tensors
    with torch.set_grad_enabled(_ag.is_recording()):
        results = op.fn(*tensors, **parsed)
    if not isinstance(results, tuple):
        results = (results,)
    results = results[:op.n_visible_outputs(parsed)]
    if out is not None:
        outs = [out] if isinstance(out, NDArray) else list(out)
        with torch.no_grad():
            for o, r in zip(outs, results):
                if r is not o._t:
                    o._t.copy_(r)
        return outs[0] if len(outs) == 1 else outs
    outputs = [NDArray(r, ctx) for r in results]
    return outputs[0] if len(outputs) == 1 else outputs


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _ctx(ctx):
    return ctx if ctx is not None else current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """An array holding a copy of ``source_array`` on ``ctx`` (default:
    the current context). Python lists and float64 numpy arrays become
    float32 unless ``dtype`` says otherwise; other numpy dtypes stay."""
    ctx = _ctx(ctx)
    if isinstance(source_array, NDArray):
        src = source_array._t.detach()
        t = src.to(device=ctx.torch_device(),
                   dtype=src.dtype if dtype is None else dtype_torch(dtype),
                   copy=True)
        return NDArray(t, ctx)
    was_array = isinstance(source_array, np.ndarray)
    a = np.asarray(source_array)
    if dtype is None:
        dtype = np.float32 if (not was_array or a.dtype == np.float64) \
            else a.dtype
    t = torch.from_numpy(np.ascontiguousarray(
        a if dtype_name(dtype) == "bfloat16" else a.astype(
            np.dtype(dtype_name(dtype)), copy=False)))
    return NDArray(t.to(device=ctx.torch_device(), dtype=dtype_torch(dtype),
                        copy=True), ctx)


def empty(shape, ctx=None, dtype=None):
    ctx = _ctx(ctx)
    return NDArray(torch.empty(_shape(shape), dtype=dtype_torch(dtype),
                               device=ctx.torch_device()), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    ctx = _ctx(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                               device=ctx.torch_device()), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    ctx = _ctx(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                              device=ctx.torch_device()), ctx)


def full(shape, val, ctx=None, dtype=None, out=None):
    if out is not None:
        out[:] = val
        return out
    ctx = _ctx(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=dtype_torch(dtype),
                              device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    ctx = _ctx(ctx)
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch.float64).to(
        dtype=dtype_torch(dtype), device=ctx.torch_device())
    if repeat != 1:
        t = t.repeat_interleave(int(repeat))
    return NDArray(t, ctx)


def zeros_like(other):
    return NDArray(torch.zeros_like(other._t), other._ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return invoke("Concat", list(arrays), {"dim": axis})


def waitall():
    """Wait until every queued kernel of every card has finished."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
