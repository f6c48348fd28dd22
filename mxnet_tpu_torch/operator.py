"""Custom operators written in Python (``mx.operator``; counterpart of
``mxnet_tpu/operator.py``).

The user surface is the JAX package's and MXNet's: a ``CustomOpProp``
registered under a name declares arity, shapes and types, and its
``create_operator`` returns a ``CustomOp`` whose ``forward`` and
``backward`` fill their output NDArrays (``assign``). ``mx.nd.Custom`` and
``mx.sym.Custom`` (``ops/custom.py``) run it imperatively, in a bound
graph and under autograd.

The bridge, :func:`custom_call`, is a ``torch.autograd.Function``
(:class:`_CustomFunction`): its forward calls the op's ``forward`` and its
backward the op's ``backward``. Each gets NDArrays that wrap the tensors
on the executor's device, so the body may launch work on the card (an
``rtc`` kernel, torch ops) where the JAX package must copy to host numpy
for ``jax.pure_callback``. On ``meta`` tensors (the port's shape
inference) the outputs come from the prop's ``infer_shape`` and
``infer_type`` alone and the body is never called.

    @mx.operator.register("softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def list_arguments(self): return ['data']
        def list_outputs(self): return ['output']
        def infer_shape(self, in_shape): return in_shape, [in_shape[0]]
        def create_operator(self, ctx, shapes, dtypes): return Softmax()

    out = mx.nd.Custom(x, op_type="softmax")
    sym = mx.sym.Custom(data=d, op_type="softmax")
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, dtype_torch

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "PythonOp", "NumpyOp", "NDArrayOp"]

_CUSTOM_PROPS = {}


class CustomOp:
    """Base class of a custom operator's implementation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says (``write``/``inplace``
        overwrite, ``add`` accumulates, ``null`` leaves it)."""
        if req in ("null", 0):
            return
        if req in ("write", "inplace", 1, 2):
            dst[:] = src
        elif req in ("add", 3):
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req %r" % (req,))


class CustomOpProp:
    """The declarative half of a custom op: arguments, outputs, shapes,
    types and the operator it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under ``op_type=reg_name``."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("%r must subclass CustomOpProp" % prop_cls)
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_CUSTOM_PROPS)


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------
def make_prop(op_type, kwargs):
    """A fresh prop of ``op_type``; its kwargs arrive as strings, as in the
    reference."""
    if op_type not in _CUSTOM_PROPS:
        raise MXNetError(
            "custom op type %r is not registered (known: %s)"
            % (op_type, sorted(_CUSTOM_PROPS)))
    return _CUSTOM_PROPS[op_type](**{k: str(v) for k, v in kwargs.items()})


_PROP_CACHE = {}


def _cached_prop(op_type, kwargs):
    """A prop for metadata queries (arity, argument names), cached so that
    graph traversals do not rerun the user's ``__init__``; execution
    builds a fresh one (user code may keep state on it)."""
    key = (op_type, tuple(sorted((k, str(v)) for k, v in kwargs.items())))
    if key not in _PROP_CACHE:
        _PROP_CACHE[key] = make_prop(op_type, kwargs)
    return _PROP_CACHE[key]


def _normalize_infer(ret, what, n_out):
    """Accept ``(in, out)`` or ``(in, out, aux)`` from the user's
    ``infer_shape``/``infer_type`` (both are legal in the reference)."""
    if not isinstance(ret, (tuple, list)) or len(ret) not in (2, 3):
        raise MXNetError(
            "custom op %s must return (in, out) or (in, out, aux)" % what)
    ins, outs = ret[0], ret[1]
    aux = ret[2] if len(ret) == 3 else []
    if len(outs) != n_out:
        raise MXNetError(
            "custom op %s returned %d outputs, list_outputs() has %d"
            % (what, len(outs), n_out))
    return ins, outs, aux


def _np_type(dtype):
    """The numpy dtype a prop's ``infer_type`` sees for a torch dtype
    (bfloat16, which numpy lacks, stays a torch dtype)."""
    from .ndarray.ndarray import _NP_TYPES

    t = _NP_TYPES.get(dtype, dtype)
    return t if isinstance(t, torch.dtype) else np.dtype(t)


def _torch_type(dtype):
    return dtype if isinstance(dtype, torch.dtype) else \
        dtype_torch(np.dtype(dtype).name)


def _wrap(tensors, ctx):
    from .ndarray.ndarray import NDArray

    return [NDArray(t, ctx) for t in tensors]


def _zeros(specs, device, ctx):
    from .ndarray.ndarray import NDArray

    return [NDArray(torch.zeros(s, dtype=d, device=device), ctx)
            for s, d in specs]


class _CustomFunction(torch.autograd.Function):
    """The op's ``forward`` and ``backward`` as one autograd node. The
    outputs and input gradients are zero-filled buffers on the inputs'
    device that the body writes (``req`` "write")."""

    @staticmethod
    def forward(fctx, op, is_train, out_specs, *xs):
        from .context import Context

        device = xs[0].device
        ctx = Context.from_device(device)
        in_nd = _wrap([x.detach() for x in xs], ctx)
        out_nd = _zeros(out_specs, device, ctx)
        op.forward(is_train=is_train, req=["write"] * len(out_nd),
                   in_data=in_nd, out_data=out_nd, aux=[])
        outs = tuple(o.tensor for o in out_nd)
        fctx.op, fctx.ctx, fctx.n_in = op, ctx, len(xs)
        fctx.in_specs = [(tuple(x.shape), x.dtype) for x in xs]
        fctx.save_for_backward(*xs, *outs)
        return outs

    @staticmethod
    def backward(fctx, *gys):
        saved = fctx.saved_tensors
        xs, ys = saved[:fctx.n_in], saved[fctx.n_in:]
        device = xs[0].device
        in_nd = _wrap([x.detach() for x in xs], fctx.ctx)
        out_nd = _wrap([y.detach() for y in ys], fctx.ctx)
        ograd_nd = _wrap([g.detach() for g in gys], fctx.ctx)
        igrad_nd = _zeros(fctx.in_specs, device, fctx.ctx)
        fctx.op.backward(req=["write"] * len(igrad_nd), out_grad=ograd_nd,
                         in_data=in_nd, out_data=out_nd, in_grad=igrad_nd,
                         aux=[])
        return (None, None, None) + tuple(g.tensor for g in igrad_nd)


def custom_call(data, op_type, kwargs, is_train=True):
    """Run custom op ``op_type`` on the tensors ``data``; a tensor, or a
    tuple of them for several outputs.

    Shapes and types come from the prop. On ``meta`` tensors that is all:
    the body is not called. Otherwise the op is created for the inputs'
    device and runs inside :class:`_CustomFunction`, so autograd (the
    executor's, or ``autograd.record``'s) routes the gradient through its
    ``backward``. A loss head whose prop says ``need_top_grad=False`` is
    given the head gradient it ignores, as in the JAX package."""
    from .context import Context

    prop = make_prop(op_type, kwargs)
    n_out = len(prop.list_outputs())
    if prop.list_auxiliary_states():
        raise MXNetError(
            "custom op %r declares auxiliary states: not supported by the "
            "custom-op bridge, as in the JAX package" % op_type)
    if not data:
        raise MXNetError("custom op %r: no input" % op_type)
    in_shapes = [tuple(d.shape) for d in data]
    _, out_shapes, _ = _normalize_infer(
        prop.infer_shape([list(s) for s in in_shapes]), "infer_shape", n_out)
    in_types = [_np_type(d.dtype) for d in data]
    _, out_types, _ = _normalize_infer(
        prop.infer_type(in_types), "infer_type", n_out)
    out_specs = [(tuple(int(n) for n in s), _torch_type(t))
                 for s, t in zip(out_shapes, out_types)]
    device = data[0].device
    if device.type == "meta":
        outs = tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in out_specs)
    else:
        op = prop.create_operator(Context.from_device(device), in_shapes,
                                  in_types)
        outs = _CustomFunction.apply(op, bool(is_train), out_specs, *data)
    return outs[0] if n_out == 1 else tuple(outs)


def _strip(attrs):
    return {k: v for k, v in attrs.items()
            if k not in ("op_type", "__is_train__")}


def custom_num_outputs(attrs):
    op_type = attrs.get("op_type", "")
    return len(_cached_prop(op_type, _strip(attrs)).list_outputs())


def custom_arg_order(attrs):
    """The prop's ``list_arguments()``: the order named tensor kwargs bind
    in."""
    op_type = attrs.get("op_type", "")
    return list(_cached_prop(op_type, _strip(attrs)).list_arguments())


# ---------------------------------------------------------------------------
# legacy interfaces, deprecated in the reference in favour of CustomOp
# ---------------------------------------------------------------------------
class PythonOp:
    """Deprecated in the reference; subclass ``CustomOp`` instead."""

    def __init__(self, *a, **kw):
        raise MXNetError(
            "PythonOp/NumpyOp/NDArrayOp are deprecated legacy interfaces "
            "(deprecated in the reference too) — subclass "
            "mx.operator.CustomOp / CustomOpProp instead")


NumpyOp = PythonOp
NDArrayOp = PythonOp
