"""The generated ``mx.nd.<op>`` functions (counterpart of
``mxnet_tpu/ndarray/register.py``): one function per op of the port's
registry, binding NDArray arguments to the op's inputs in signature
order and everything else to its attributes; ``out=`` receives the
result in place. An op the registry does not hold raises
:class:`~..base.MXNetError` naming it as not ported (the module's
``__getattr__``)."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ops import registry as _reg
from .ndarray import NDArray, invoke


def _tensor_like(v):
    return isinstance(v, (NDArray, np.ndarray))


def make_op_func(op):
    input_names = op.input_names

    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        if op.var_inputs:
            tensors = [a for a in args if isinstance(a, NDArray)]
            attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, NDArray)}
            attrs.pop("num_args", None)
            named = {k: v for k, v in kwargs.items()
                     if isinstance(v, NDArray)}
            tensors += order_named(op, named, attrs)
            return invoke(op, tensors, attrs, out=out)
        slots = {k: v for k, v in kwargs.items() if k in input_names}
        attrs = {k: v for k, v in kwargs.items() if k not in input_names}
        pos = [a for a in args if _tensor_like(a)]
        scalars = [a for a in args if not _tensor_like(a)]
        tensors = []
        for name in input_names:
            if name in slots:
                tensors.append(slots[name])
            elif pos:
                tensors.append(pos.pop(0))
            else:
                tensors.append(None)
        if pos:
            raise MXNetError("op %s: too many positional tensor args (takes "
                             "%d)" % (op.name, len(input_names)))
        order = [k for k in op.attr_defaults if k not in attrs]
        if len(scalars) > len(order):
            raise MXNetError("op %s: too many positional args" % op.name)
        attrs.update(zip(order, scalars))
        while tensors and tensors[-1] is None:
            tensors.pop()
        tensors = [NDArray(_np_tensor(t)) if isinstance(t, np.ndarray)
                   else t for t in tensors]
        return invoke(op, tensors, attrs, out=out)

    generic_op.__name__ = op.name
    generic_op.__doc__ = op.doc
    return generic_op


def order_named(op, named, attrs):
    """The tensor kwargs of a var-input op, in its ``kwarg_input_order``
    where it has one (``Custom``: the prop's ``list_arguments()``, so they
    bind by name), else as given; a name outside that order raises."""
    if not named or op.kwarg_input_order is None:
        return list(named.values())
    order = op.kwarg_input_order(attrs)
    unknown = set(named) - set(order)
    if unknown:
        raise MXNetError("op %s: tensor kwargs %s not in its argument list "
                         "%s" % (op.name, sorted(unknown), order))
    return [named[k] for k in order if k in named]


def _np_tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


# the op namespaces: ``_contrib_X`` is ``mod.contrib.X``, ``_linalg_X``
# ``mod.linalg.X``, ``_random_X`` and ``_sample_X`` are ``mod.random.X``,
# ``_sparse_X`` is ``mod.sparse.X``, ``_image_X`` ``mod.image.X`` (no op
# has that prefix: ``mod.image`` is empty, as in the JAX package)
_ROUTES = (("_contrib_", "contrib"), ("_linalg_", "linalg"),
           ("_random_", "random"), ("_sample_", "random"),
           ("_sparse_", "sparse"), ("_image_", "image"))
# mod.random.<dist>: scalar parameters draw from _random_<dist>, tensor
# parameters from _sample_<dist> (the negative binomials have no _sample_
# form: mod.random holds their _random_ op, routed above)
_DISTRIBUTIONS = ("uniform", "normal", "gamma", "exponential", "poisson")


def populate_module(mod, maker=make_op_func, tensor_type=NDArray):
    """Install every registered op (and alias) as a function on ``mod``
    (made by ``maker``), and the prefixed names also in the namespaces of
    ``_ROUTES`` under their bare names, as the JAX package routes them
    (``mx.nd.contrib.MultiBoxPrior``, ``mx.nd.random.uniform``, ...).
    ``mod.random.<dist>`` dispatches on whether an argument is a
    ``tensor_type``; ``mod.random`` also holds ``multinomial``,
    ``randint`` and ``shuffle``. A namespace module that ``mod`` already
    holds (``mx.nd.sparse``, the real submodule) receives its ops."""
    import types

    sub = {}
    for _prefix, ns in _ROUTES:
        if ns not in sub:
            sub[ns] = getattr(mod, ns, None)
            if not isinstance(sub[ns], types.ModuleType):
                sub[ns] = types.ModuleType("%s.%s" % (mod.__name__, ns))
                setattr(mod, ns, sub[ns])
    for name in _reg.list_ops():
        fn = maker(_reg.get(name))
        setattr(mod, name, fn)
        for prefix, ns in _ROUTES:
            if name.startswith(prefix):
                setattr(sub[ns], name[len(prefix):], fn)
    rnd = sub["random"]
    for dist in _DISTRIBUTIONS:
        rand_fn = maker(_reg.get("_random_" + dist))
        samp_fn = maker(_reg.get("_sample_" + dist))

        def dispatch(*args, _r=rand_fn, _s=samp_fn, **kwargs):
            tensors = any(isinstance(a, tensor_type)
                          for a in args + tuple(kwargs.values()))
            return (_s if tensors else _r)(*args, **kwargs)

        dispatch.__name__ = dist
        setattr(rnd, dist, dispatch)
    rnd.multinomial = maker(_reg.get("_sample_multinomial"))
    rnd.randint = maker(_reg.get("_random_randint"))
    rnd.shuffle = maker(_reg.get("shuffle"))
    return mod


def not_ported(module_name):
    """A module ``__getattr__`` raising for ops the registry lacks."""
    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise MXNetError("%s.%s: operator %r is not ported"
                         % (module_name, name, name))

    return __getattr__
