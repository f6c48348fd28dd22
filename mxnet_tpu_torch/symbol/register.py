"""The generated ``sym.<Op>(...)`` functions (counterpart of
``mxnet_tpu/symbol/register.py``): each composes a graph node. Missing
parameter inputs become variables named ``{name}_{param}`` (the
reference's auto-variables, e.g. ``conv1_weight``). ``RNN``'s flat
``parameters`` variable carries the ``fusedrnn`` initializer in its
``__init__`` attribute, and an ``lstm`` gets its ``state_cell``
variable."""
from __future__ import annotations

import json

from ..base import MXNetError, auto_name
from ..ops.registry import OpDef
from .symbol import Symbol, _Node, var


def create_symbol(op: OpDef, input_syms, attrs, name=None, arity_names=None):
    """Build a Symbol node applying ``op`` to input symbols."""
    name = name or auto_name(_prefix_for(op.name))
    entries = []
    for s in input_syms:
        if s is None:
            entries.append(None)
        elif isinstance(s, Symbol):
            if len(s._entries) != 1:
                raise MXNetError("cannot use a grouped symbol as op input")
            entries.append(s._entries[0])
        else:
            raise MXNetError("op %s: expected Symbol input, got %r"
                             % (op.name, type(s)))
    while entries and entries[-1] is None:   # drop trailing Nones
        entries.pop()
        if arity_names:
            arity_names = arity_names[:-1]
    if any(e is None for e in entries):
        raise MXNetError("op %s: non-trailing missing input" % op.name)
    parsed = op.parse_attrs({k: v for k, v in attrs.items() if v is not None})
    from ..attribute import current_attrs

    node = _Node(op, parsed, entries, name, attr_dict=current_attrs(),
                 arity=arity_names or _default_arity(op, len(entries)))
    return Symbol([(node, i) for i in range(op.n_visible_outputs(parsed))])


def _default_arity(op, n):
    if op.var_inputs:
        return tuple("arg%d" % i for i in range(n))
    return op.input_names[:n]


def _prefix_for(opname):
    return opname.lstrip("_").lower()


def make_symbol_func(op: OpDef):
    input_names = op.input_names

    def symbol_op(*args, **kwargs):
        name = kwargs.pop("name", None) or auto_name(_prefix_for(op.name))
        if op.var_inputs:
            # Concat-style: the Symbol arguments, positional then by
            # keyword (in the op's kwarg_input_order where it has one),
            # are the inputs; num_args follows from them
            from ..ndarray.register import order_named

            tensors = [a for a in args if isinstance(a, Symbol)]
            attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, Symbol)}
            attrs.pop("num_args", None)
            tensors += order_named(op, {k: v for k, v in kwargs.items()
                                        if isinstance(v, Symbol)}, attrs)
            return create_symbol(op, tensors, attrs, name=name,
                                 arity_names=tuple("arg%d" % i for i in
                                                   range(len(tensors))))
        slots = {k: v for k, v in kwargs.items() if k in input_names}
        attrs = {k: v for k, v in kwargs.items() if k not in input_names}
        tensors, pos = [], list(args)
        for pname in input_names:
            if pname in slots:
                tensors.append(slots[pname])
            elif pos:
                tensors.append(pos.pop(0))
            else:
                tensors.append(None)
        if pos:
            raise MXNetError("op %s: too many positional args" % op.name)
        needed = _needed_inputs(op, attrs, tensors)
        for i, pname in enumerate(input_names):
            if tensors[i] is None and pname in needed:
                tensors[i] = var("%s_%s" % (name, pname),
                                 attr=_var_attr(op, pname, attrs))
        return create_symbol(op, tensors, attrs, name=name,
                             arity_names=input_names[:len(tensors)])

    symbol_op.__name__ = op.name
    symbol_op.__doc__ = op.doc
    return symbol_op


def _var_attr(op, pname, attrs):
    """The attributes of an auto-created variable: ``RNN``'s flat
    ``parameters`` get the ``fusedrnn`` initializer (so Xavier and the
    like never see a flat vector)."""
    if op.name != "RNN" or pname != "parameters":
        return None
    from ..ops.registry import _coerce

    return {"__init__": json.dumps(["fusedrnn", {
        "num_hidden": int(attrs.get("state_size", 0)),
        "num_layers": int(attrs.get("num_layers", 1)),
        "mode": str(attrs.get("mode", "lstm")),
        "bidirectional": bool(_coerce(attrs.get("bidirectional", False),
                                      True)),
    }])}


def _needed_inputs(op, attrs, tensors):
    """Which missing inputs must be auto-created as variables."""
    names = op.input_names
    last = max((i for i, t in enumerate(tensors) if t is not None),
               default=-1)
    needed = {pname for i, pname in enumerate(names) if i <= last}
    no_bias = attrs.get("no_bias") in (True, "True", "true", 1, "1")
    for pname in names:
        if pname in ("weight", "gamma", "beta", "moving_mean", "moving_var",
                     "label", "parameters", "state"):
            needed.add(pname)
        if pname == "bias" and not no_bias:
            needed.add(pname)
    if op.name == "RNN" and attrs.get("mode") == "lstm":
        needed.add("state_cell")
    if op.name == "FusedBottleneckUnit":
        # the shortcut conv weight exists only in downsample units
        dim_match = attrs.get("dim_match", True) in (True, "True", "true",
                                                     1, "1")
        for pname in names:
            if pname == "sc_weight":
                if not dim_match:
                    needed.add(pname)
            elif pname != "data":
                needed.add(pname)
    return needed
