"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A parameter holds one NDArray on one context (the JAX package's single
buffer design: initialised on a context list, it keeps its one copy on the
first, and ``list_ctx`` gives the list) and, unless its ``grad_req``
is ``null``, a gradient buffer of the same shape: the data array is an
autograd variable (``autograd.mark_variables``), so a recorded forward's
``backward`` writes the buffer. A shape with unknown (0) dims defers
initialization to the first forward that reveals it.

``ParameterDict.save``/``load`` read and write the NDArray file format
both packages share (``nd.save``/``nd.load``): a ``.params`` file either
package writes loads in the other with the same names.
"""
from __future__ import annotations

import numpy as np

from .. import autograd
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Initializer, Uniform
from ..initializer import create as create_init
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A parameter whose shape is not known yet was read."""


class Parameter:
    """One named weight: its data, its gradient buffer and how an optimizer
    treats it (``lr_mult``, ``wd_mult``, ``grad_req``)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req if differentiable else "null"
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if any(s == 0 for s in self._shape):
            if len(self._shape) != len(new_shape):
                raise MXNetError("Parameter %s shape mismatch: %s vs %s"
                                 % (self.name, self._shape, new_shape))
            self._shape = tuple(n if o == 0 else o
                                for o, n in zip(self._shape, new_shape))
        elif tuple(self._shape) != tuple(new_shape):
            raise MXNetError("Parameter %s shape mismatch: %s vs %s"
                             % (self.name, self._shape, new_shape))

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill the data on ``ctx`` (default: the current
        context) with ``init``, else the parameter's own ``init``, else
        ``default_init`` (``Uniform()``); deferred while the shape has
        unknown dims."""
        if default_init is None:
            default_init = Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        if self._shape is None or any(s == 0 for s in self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError("Cannot initialize Parameter %s because it has "
                             "invalid shape %s" % (self.name, self._shape))
        self._finish_init(init, default_init)

    def _finish_init(self, init, default_init):
        data = nd.zeros(self._shape, ctx=self._ctx_list[0], dtype=self.dtype)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = create_init(initializer)
        initializer(InitDesc(self.name), data)
        self._data = data
        if self.grad_req != "null":
            self._grad = nd.zeros(self._shape, ctx=self._ctx_list[0],
                                  dtype=self.dtype)
            autograd.mark_variables([self._data], [self._grad],
                                    grad_reqs=self.grad_req)
        self._deferred_init = ()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, _ctx, default_init = self._deferred_init
        if self._shape is None or any(s == 0 for s in self._shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape; run a forward pass first"
                % self.name)
        self._finish_init(init, default_init)

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s was not initialized: deferred init pending "
                    "first forward" % self.name)
            raise MXNetError("Parameter %s has not been initialized. Call "
                             "initialize() first" % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad is None:
            raise MXNetError("Parameter %s does not have gradients "
                             "(grad_req=null)" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None and self._deferred_init:
            return self._deferred_init[1]
        self._check_initialized()
        return self._ctx_list or [self._data.context]

    def set_data(self, data):
        """Copy ``data`` (an NDArray or array-like) into the parameter,
        finishing a deferred initialization first."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter %s not initialized" % self.name)
            self._finish_deferred_init()
        src = data if isinstance(data, NDArray) else nd.array(data)
        src.copyto(self._data)

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def reset_ctx(self, ctx):
        """One buffer on one context: nothing to move."""

    def var(self):
        """The symbol variable of this parameter (one per parameter)."""
        from .. import symbol as sym

        if self._var is None:
            self._var = sym.var(self.name, shape=self._shape,
                                lr_mult=self.lr_mult, wd_mult=self.wd_mult)
        return self._var

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            self._data = self._data.astype(dtype)
            if self._grad is not None:
                self._grad = self._grad.astype(dtype)
                autograd.mark_variables([self._data], [self._grad],
                                        grad_reqs=self.grad_req)


class Constant(Parameter):
    """A parameter that never takes a gradient, initialized to ``value``."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value)
        self.value = value

        class _CInit(Initializer):
            def _init_weight(self2, _, arr):
                value.copyto(arr)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """Parameters by full name, all starting with ``prefix``; ``shared``
    lends its parameters to ``get``."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(
            name=name, content="\n".join(repr(v)
                                         for v in self._params.values()))

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` when new;
        an existing one must agree with them (unknown shape dims merge)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if v is None:
                continue
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape":
                param.shape = v
            elif k in ("init", "allow_deferred_init", "differentiable"):
                continue
            elif k == "dtype":
                if np.dtype(existing) != np.dtype(v):
                    raise MXNetError("Parameter %s: inconsistent dtype %s vs "
                                     "existing %s" % (name, v, existing))
            elif existing != v:
                raise MXNetError("Parameter %s: inconsistent attribute %s=%r "
                                 "vs existing %r" % (name, k, v, existing))
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("No constant named %s" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other: duplicate "
                                 "key %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        """One buffer on one context: nothing to move."""

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Every parameter's data into an NDArray file, by name with
        ``strip_prefix`` taken off."""
        from ..ndarray.utils import save

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError(
                    "Prefix %s is to be striped before saving, but Parameter "
                    "%s does not start with %s" % (strip_prefix, param.name,
                                                   strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set each parameter from an NDArray file whose names lack
        ``restore_prefix``."""
        from ..ndarray.utils import load

        arg_dict = {restore_prefix + k: v for k, v in load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter %s is missing in file %s"
                                     % (name, filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter %s loaded from file %s is not present in "
                        "this dict" % (name, filename))
                continue
            self[name].set_data(value)
