"""Imperative autograd over torch autograd (counterpart of
``mxnet_tpu/autograd.py``).

``record()`` turns recording on for a block: ``NDArray`` ops run with
torch's grad mode on only while recording, so torch builds the tape that
the JAX package keeps as its own. ``mark_variables`` (and
``NDArray.attach_grad``) makes an array a leaf that requires grad, with a
gradient buffer and a ``grad_req``; :func:`backward` takes the gradients
of every marked variable with ``torch.autograd.grad`` and writes them
into the buffers (``write``), adds them (``add``) or leaves them
(``null``). The graph is freed unless ``retain_graph``. A custom
:class:`Function` runs its NDArray ``forward``/``backward`` inside a
``torch.autograd.Function``.

Each op recorded through ``ndarray.invoke`` also leaves on its outputs
which op made them from which arrays, so :func:`get_symbol` can rebuild
the recorded graph as a Symbol.

``train_mode`` of :func:`backward` and :func:`grad` has no effect: torch
differentiates the recorded forward, whose mode was fixed when it ran
(the JAX package re-evaluates it in ``train_mode``).
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError

_STATE = threading.local()
# NDArrays with a gradient buffer, by id (a WeakSet would compare two
# NDArrays with ==, which is elementwise)
_MARKED = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_rec):
    prev = _st().recording
    _st().recording = bool(is_rec)
    return prev


def set_training(train_mode):
    prev = _st().training
    _st().training = bool(train_mode)
    return prev


@contextmanager
def _scope(recording, training):
    prev_rec = set_recording(recording) if recording is not None else None
    prev_train = set_training(training)
    try:
        yield
    finally:
        if recording is not None:
            set_recording(prev_rec)
        set_training(prev_train)


def record(train_mode=True):
    """Record the ops of the block for :func:`backward`."""
    return _scope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a :func:`record` block."""
    return _scope(False, train_mode)


def train_mode():
    return _scope(None, True)


def predict_mode():
    return _scope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf that requires grad, with ``gradients`` as
    its buffer and ``grad_reqs`` (``write``, ``add`` or ``null``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        var._t = var._t.detach().requires_grad_(True)
        var._grad = grad
        var._grad_req = req
        _MARKED[id(var)] = var


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, grads = [], []
    for h, g in zip(heads, head_grads):
        if not h._t.requires_grad:
            raise MXNetError("cannot differentiate: array is not in a "
                             "recorded graph")
        outs.append(h._t)
        if isinstance(g, NDArray):
            g = g._t
        grads.append(torch.ones_like(h._t) if g is None
                     else torch.as_tensor(g, dtype=h._t.dtype,
                                          device=h._t.device))
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (times ``head_grads``, default ones) into the
    buffers of every marked variable they reach."""
    outs, grads = _heads(heads, head_grads)
    leaves = [v for v in list(_MARKED.values())
              if v._grad_req != "null" and v._t.requires_grad
              and v._t.is_leaf]
    if not leaves:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)
        return
    got = torch.autograd.grad(outs, [v._t for v in leaves], grads,
                              retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(leaves, got):
            if g is None:
                continue
            if v._grad_req == "add":
                v._grad._t.add_(g)
            else:
                v._grad._t.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` as new
    arrays, without touching any buffer. Each variable must have been
    marked (``attach_grad``) before the forward was recorded."""
    from .ndarray.ndarray import NDArray

    variables = list(variables) if isinstance(variables, (list, tuple)) \
        else [variables]
    for v in variables:
        if not v._t.requires_grad:
            raise MXNetError("autograd.grad: a variable was not marked "
                             "(attach_grad) before recording")
    outs, grads = _heads(heads, head_grads)
    retain = bool(create_graph) if retain_graph is None else retain_graph
    got = torch.autograd.grad(outs, [v._t for v in variables], grads,
                              retain_graph=retain,
                              create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v._t) if g is None else
                    (g if create_graph else g.detach()), v._ctx)
            for v, g in zip(variables, got)]


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s NDArray forward and backward."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray

        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return tuple(o._t for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray

        with pause():
            in_grads = ctx.fn.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None,) + tuple(None if g is None else g._t for g in in_grads)


class Function:
    """A user-defined differentiable function: subclass and implement
    ``forward`` and ``backward`` on NDArrays."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        with torch.set_grad_enabled(is_recording()):
            outs = _Bridge.apply(self, *[x._t for x in inputs])
        ctx = inputs[0]._ctx if inputs else None
        outs = [NDArray(t, ctx) for t in outs]
        return outs[0] if len(outs) == 1 else outs


def get_symbol(x):
    """The recorded imperative graph that reaches ``x`` as a Symbol, as
    the JAX package builds it: leaf arrays (inputs and marked variables)
    become variables ``var0, var1, ...`` in first-use order, and each
    recorded op a node named after its op and its build order."""
    from .symbol.symbol import Symbol, _infer_arity, _Node

    if getattr(x, "_op_record", None) is None:
        raise MXNetError(
            "autograd.get_symbol: array is not the output of a recorded op")
    node_memo, var_memo = {}, {}

    def entry_for_array(arr):
        rec = getattr(arr, "_op_record", None)
        if rec is not None:
            return build(rec), rec[3]
        if id(arr) not in var_memo:
            var_memo[id(arr)] = _Node(None, {}, [], "var%d" % len(var_memo))
        return var_memo[id(arr)], 0

    def build(rec):
        op, attrs, arrays, _index = rec
        key = (id(op), id(arrays))
        if key in node_memo:
            return node_memo[key]
        arrays = list(arrays)
        while arrays and arrays[-1] is None:
            arrays.pop()
        if any(a is None for a in arrays):
            raise MXNetError(
                "autograd.get_symbol: op %s was recorded with a "
                "non-trailing missing optional input" % op.name)
        inputs = [entry_for_array(a) for a in arrays]
        node = _Node(op, dict(attrs), inputs, "%s%d" % (
            op.name.lstrip("_").lower(), len(node_memo)),
            arity=_infer_arity(op, len(inputs)))
        node_memo[key] = node
        return node

    return Symbol([entry_for_array(x)])
