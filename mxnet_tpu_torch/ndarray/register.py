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
            tensors += [v for v in kwargs.values() if isinstance(v, NDArray)]
            attrs.pop("num_args", None)
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


def _np_tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def populate_module(mod):
    """Install every registered op (and alias) as a function on ``mod``."""
    for name in _reg.list_ops():
        setattr(mod, name, make_op_func(_reg.get(name)))
    return mod


def not_ported(module_name):
    """A module ``__getattr__`` raising for ops the registry lacks."""
    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise MXNetError("%s.%s: operator %r is not ported"
                         % (module_name, name, name))

    return __getattr__
