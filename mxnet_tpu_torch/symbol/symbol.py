"""Symbol: declarative graph composition (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is an ordered list of output entries ``(node, out_index)`` of a
DAG of :class:`_Node`; a node is a variable (``op`` None) or an op
application. JSON save/load keeps the reference's file format
(``nodes``/``arg_nodes``/``heads``), so a graph written by either package
loads in the other (``Symbol.save``, :func:`load`). Arithmetic with a
Symbol or a number composes the broadcast and ``_*_scalar`` ops;
``bind``/``simple_bind`` give an ``executor.Executor``.
"""
from __future__ import annotations

import json

from ..base import MXNetError
from ..ops import registry as _reg

# ops whose trailing inputs are auxiliary states, not arguments
_AUX_PARAMS = {
    "BatchNorm": {"moving_mean", "moving_var"},
    "BatchNorm_v1": {"moving_mean", "moving_var"},
    "batch_norm": {"moving_mean", "moving_var"},
}


class _Node:
    """One graph node: a variable (op is None) or an op application."""

    __slots__ = ("op", "attrs", "inputs", "name", "attr_dict", "_arity")

    def __init__(self, op, attrs, inputs, name, attr_dict=None, arity=None):
        self.op = op                     # OpDef, or None for a variable
        self.attrs = attrs               # parsed op attrs
        self.inputs = inputs             # list[(node, out_index)]
        self.name = name
        self.attr_dict = attr_dict or {}  # user attrs (__shape__, ...)
        self._arity = arity              # input param names, per input

    def n_outputs(self):
        return 1 if self.op is None else self.op.n_outputs(self.attrs)

    def is_variable(self):
        return self.op is None


class Symbol:
    """An (ordered) set of output entries of a graph."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group [%d]" % len(self._entries))

    def __getitem__(self, index):
        if isinstance(index, str):
            for i, nm in enumerate(self.list_outputs()):
                if nm == index:
                    return Symbol([self._entries[i]])
            raise MXNetError("no output named %r" % index)
        entries = self._entries[index]
        if isinstance(index, slice):
            return Symbol(entries)
        return Symbol([entries])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @property
    def outputs(self):
        return self._entries

    def get_internals(self):
        """Symbol grouping every output of every node, in topo order."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.n_outputs())])

    # -- graph traversal -----------------------------------------------------
    def _topo(self):
        seen, order = set(), []

        def visit(node):
            # iterative: a ResNet-152 graph is deeper than the recursion
            # limit allows for comfortably
            stack = [(node, False)]
            while stack:
                n, done = stack.pop()
                if done:
                    order.append(n)
                    continue
                if id(n) in seen:
                    continue
                seen.add(id(n))
                stack.append((n, True))
                for inp, _ in reversed(n.inputs):
                    if id(inp) not in seen:
                        stack.append((inp, False))

        for node, _ in self._entries:
            visit(node)
        return order

    def _var_nodes(self):
        return [n for n in self._topo() if n.is_variable()]

    def data_dependent_nodes(self, dynamic_names):
        """Topo indices (into :meth:`_topo` order) of every node whose value
        depends on a variable named in ``dynamic_names``: the split behind
        the serving predictor's bind-time folding."""
        dynamic_names = set(dynamic_names)
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        dep = set()
        for i, node in enumerate(nodes):
            if node.is_variable():
                if node.name in dynamic_names:
                    dep.add(i)
                continue
            if any(node_ids[id(inp)] in dep for inp, _ in node.inputs):
                dep.add(i)
        return dep

    def _aux_names_set(self):
        aux = set()
        for node in self._topo():
            if node.op is None or node._arity is None:
                continue
            aux_params = set(_AUX_PARAMS.get(node.op.name, ()))
            aux_params |= set(node.op.aux_state_outputs)
            for pname, (inode, _) in zip(node._arity, node.inputs):
                if pname in aux_params and inode.is_variable():
                    aux.add(inode.name)
        return aux

    def list_arguments(self):
        aux = self._aux_names_set()
        return [n.name for n in self._var_nodes() if n.name not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_names_set()
        return [n.name for n in self._var_nodes() if n.name in aux]

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.is_variable():
                out.append(node.name)
            elif node.n_outputs() == 1:
                out.append(node.name + "_output")
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    def list_inputs(self):
        return [n.name for n in self._var_nodes()]

    # -- attributes ----------------------------------------------------------
    def attr(self, key):
        return self._entries[0][0].attr_dict.get(key)

    def _set_attr(self, **kwargs):
        self._entries[0][0].attr_dict.update(kwargs)

    def list_attr(self):
        node = self._entries[0][0]
        d = dict(node.attr_dict)
        if node.op is not None:
            d.update({k: str(v) for k, v in node.attrs.items()})
        return d

    def attr_dict(self):
        """``{node name: {attribute: value}}`` of every node with any, the
        op attributes as strings (the JAX package's ``attr_dict``)."""
        out = {}
        for node in self._topo():
            d = dict(node.attr_dict)
            if node.op is not None:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    # -- inference -----------------------------------------------------------
    def infer_type(self, **kwargs):
        """``(arg_types, out_types, aux_types)`` from input dtypes given by
        name (see ``executor.infer_graph_types``)."""
        from ..executor import infer_graph_types

        return infer_graph_types(self, kwargs)

    # -- binding -------------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        from ..executor import simple_bind

        return simple_bind(self, ctx, grad_req=grad_req, type_dict=type_dict,
                           shared_exec=shared_exec, group2ctx=group2ctx,
                           **kwargs)

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from input shapes given
        by name; raises when a shape stays unresolved."""
        from ..executor import infer_graph_shapes

        return infer_graph_shapes(self, kwargs)

    # -- serialization (reference JSON format) -------------------------------
    def tojson(self):
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, node in enumerate(nodes):
            if node.is_variable():
                arg_nodes.append(i)
                jnodes.append({"op": "null", "name": node.name, "inputs": []})
            else:
                jnodes.append({
                    "op": node.op.name,
                    "name": node.name,
                    "attrs": {k: str(v) for k, v in node.attrs.items()},
                    "inputs": [[node_ids[id(inp)], idx, 0]
                               for inp, idx in node.inputs],
                })
            if node.attr_dict:
                jnodes[-1].setdefault("attrs", {}).update(
                    {k: str(v) for k, v in node.attr_dict.items()})
        heads = [[node_ids[id(n)], idx, 0] for n, idx in self._entries]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(jnodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 10000]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- composition sugar ---------------------------------------------------
    def _apply(self, opname, other=None, scalar_op=None, reverse=False,
               **attrs):
        from .register import create_symbol

        if other is None:
            return create_symbol(_reg.get(opname), [self], attrs)
        if isinstance(other, Symbol):
            return create_symbol(_reg.get(opname),
                                 [other, self] if reverse else [self, other],
                                 attrs)
        if isinstance(other, (int, float)):
            return create_symbol(_reg.get(scalar_op), [self],
                                 {"scalar": float(other)})
        raise MXNetError("Symbol arithmetic with %r is not supported"
                         % type(other))

    def __add__(self, other):
        return self._apply("broadcast_add", other, "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._apply("broadcast_sub", other, "_minus_scalar")

    def __rsub__(self, other):
        return self._apply("broadcast_sub", other, "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._apply("broadcast_mul", other, "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._apply("broadcast_div", other, "_div_scalar")

    def __rtruediv__(self, other):
        return self._apply("broadcast_div", other, "_rdiv_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._apply("broadcast_power", other, "_power_scalar")

    def __rpow__(self, other):
        return self._apply("broadcast_power", other, "_rpower_scalar",
                           reverse=True)

    def __neg__(self):
        return self._apply("negative")

    def reshape(self, shape):
        return self._apply("Reshape", shape=tuple(shape))

    def sum(self, axis=None, keepdims=False):
        return self._apply("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._apply("mean", axis=axis, keepdims=keepdims)

    def astype(self, dtype):
        return self._apply("Cast", dtype=str(dtype))


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """Create a symbolic variable; the active ``AttrScope``'s attributes
    apply, explicit ones win."""
    from ..attribute import current_attrs

    attr_dict = current_attrs()
    attr_dict.update(attr or {})
    if shape is not None:
        attr_dict["__shape__"] = tuple(shape)
    if dtype is not None:
        attr_dict["__dtype__"] = str(dtype)
    if lr_mult is not None:
        attr_dict["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attr_dict["__wd_mult__"] = wd_mult
    if init is not None:
        attr_dict["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    attr_dict.update(kwargs)
    return Symbol([(_Node(None, {}, [], name, attr_dict), 0)])


Variable = var


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname):
    """A symbol from a JSON file (``Symbol.save`` of either package)."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Load symbol JSON in the reference's (current) format."""
    data = json.loads(json_str)
    jmap = []
    for jn in data["nodes"]:
        jattrs = jn.get("attrs", jn.get("attr", {}))
        if jn["op"] == "null":
            node = _Node(None, {}, [], jn["name"], dict(jattrs))
        else:
            op = _reg.get(jn["op"])
            user = {k: v for k, v in jattrs.items()
                    if k.startswith("__") or k not in op.attr_defaults}
            attrs = op.parse_attrs({k: v for k, v in jattrs.items()
                                    if not k.startswith("__")
                                    and k in op.attr_defaults})
            inputs = [(jmap[e[0]], e[1]) for e in jn["inputs"]]
            node = _Node(op, attrs, inputs, jn["name"], user,
                         _infer_arity(op, len(inputs)))
        jmap.append(node)
    heads = data.get("heads", [[len(jmap) - 1, 0, 0]])
    return Symbol([(jmap[h[0]], h[1]) for h in heads])


def _infer_arity(op, n_inputs):
    if op.var_inputs:
        return tuple("arg%d" % i for i in range(n_inputs))
    return op.input_names[:n_inputs]
