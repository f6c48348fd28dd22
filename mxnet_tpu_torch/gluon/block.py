"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock`` (counterpart of
``mxnet_tpu/gluon/block.py``).

Names: a block's prefix comes from the process-global counters
(``base.auto_name``) at the top level and from its parent's per-hint
counter inside a ``name_scope`` (``_BlockScope``), as in the JAX package,
so one construction gives the same parameter names in both packages and
their ``.params`` files load in each other.

``hybridize()`` is the CachedOp analogue. The JAX package jits one
function of (inputs, params); here the block's forward is traced once to
a ``Symbol`` (the layers' ``invoke`` calls compose graph nodes when given
Symbols, one variable a parameter, named as the parameter), and that
graph runs through the executor's evaluation (``executor._graph_closure``)
on the inputs' and the parameters' tensors. The graph is keyed, as the
JAX cache is, on the inputs' shapes and dtypes, training and recording.
Autograd flows through torch: under ``autograd.record()`` the parameters'
tensors are the leaves ``backward`` fills. A training call's auxiliary
states (BatchNorm's running mean and variance) are written once, after
the graph ran. ``export`` writes the same trace as ``-symbol.json`` with
the parameters as ``-%04d.params``; ``SymbolBlock`` runs such a graph.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from ..base import MXNetError, auto_name
from ..name import NameManager
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name scoping for parameter prefixes."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = auto_name(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    if len(lines) == 1:
        return s_
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)


class Block:
    """The base of every layer and model: children, parameters, names."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(repr(block), 2))
            for key, block in self._children.items())
        return "{name}(\n{modstr}\n)".format(name=self.__class__.__name__,
                                              modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for %s from %s to %s "
                                "is not allowed." % (name, type(existing),
                                                     type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if self._reg_params.get(name, value) is not value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and its children's parameters (those whose names
        match the regular expression ``select``, when given)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    load_parameters = load_params

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        try:
            out = self.forward(*args)
        except RuntimeError as e:
            raise _one_copy_error(self, e)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        raise NotImplementedError


class HybridBlock(Block):
    """A block whose forward traces to one graph: ``hybridize()`` runs that
    graph in place of the layer-by-layer forward, ``export`` saves it."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached = {}

    def hybridize(self, active=True, **kwargs):
        """Run the traced graph in place of the forward (``kwargs``, the
        reference's CachedOp flags, change nothing here)."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def _clear_cached_op(self):
        self._cached = {}

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s has "
                "type %s." % (str(block), str(type(block))))
        super().register_child(block, name)
        self._clear_cached_op()

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Resolve the deferred parameter shapes from example inputs: one
        forward in predict mode, not recorded (the parameters it meets
        are initialized, as a first call would)."""
        with autograd.pause():
            self.forward(*args)

    def __call__(self, *args):
        self._num_inputs = len(args)   # export() traces as many inputs
        if self._active:
            try:
                out = self._call_cached(args)
            except RuntimeError as e:
                raise _one_copy_error(self, e)
            for hook in self._forward_hooks:
                hook(self, args, out)
            return out
        return super().__call__(*args)

    def _collect_all_reg_params(self):
        out = {}

        def walk(block):
            for p in block._reg_params.values():
                out[p.name] = p
            for c in block._children.values():
                walk(c)

        walk(self)
        return out

    def _trace(self, n_inputs, structure=None):
        """The forward as a Symbol of inputs ``data`` (or ``data0``, ...),
        every hybridized block of the tree running its forward meanwhile.
        ``structure`` (of :func:`_flatten`) nests the inputs as the call
        did: a recurrent cell takes ``(x, [h, c])``. A nested output comes
        back as one group and its structure: ``(symbol, out_structure)``
        when ``structure`` is given."""
        from .. import symbol as symmod

        ins = [symmod.var("data" if n_inputs == 1 else "data%d" % i)
               for i in range(n_inputs)]
        if structure is not None:
            ins = _unflatten(ins, structure)
        saved = {}

        def walk(b):
            if isinstance(b, HybridBlock):
                saved[b] = b._active
                b._active = False
            for c in b._children.values():
                walk(c)

        walk(self)
        try:
            out = self.forward(*ins)
        finally:
            for b, a in saved.items():
                b._active = a
        if structure is not None:
            if isinstance(out, symmod.Symbol) and len(out) > 1:
                out = list(out)   # a multi-output node: its outputs
            flat, out_structure = _flatten([out])
            return symmod.Group(flat), out_structure
        if isinstance(out, (list, tuple)):
            out = symmod.Group(list(out))
        return out

    def export(self, path, epoch=0):
        """Write the forward's graph to ``path-symbol.json`` and its
        parameters (``arg:`` and ``aux:`` names) to ``path-%04d.params``;
        run a forward first, so that every parameter is initialized."""
        from ..ndarray import utils as nd_utils

        params = self._collect_all_reg_params()
        for p in params.values():
            p.data()
        out = self._trace(getattr(self, "_num_inputs", 1))
        out.save("%s-symbol.json" % path)
        arg_names = set(out.list_arguments())
        aux_names = set(out.list_auxiliary_states())
        save_dict = {}
        for name, p in params.items():
            if name in arg_names:
                save_dict["arg:%s" % name] = p.data()
            elif name in aux_names:
                save_dict["aux:%s" % name] = p.data()
        nd_utils.save("%s-%04d.params" % (path, epoch), save_dict)
        return out

    # -- the CachedOp analogue -------------------------------------------
    def _call_cached(self, args):
        inputs, structure = _flatten(args)
        params = self._collect_all_reg_params()
        try:
            for p in params.values():
                p.data()
        except DeferredInitializationError:
            # the first call reveals the deferred shapes: run it eagerly
            return self.forward(*args)
        key = (tuple((tuple(a.shape), str(a.dtype)) for a in inputs),
               structure, autograd.is_training(), autograd.is_recording())
        run = self._cached.get(key)
        if run is None:
            with NameManager():
                graph, out_structure = self._trace(len(inputs), structure)
            run = self._cached[key] = _GraphCall(
                graph, ["data" if len(inputs) == 1 else "data%d" % i
                        for i in range(len(inputs))], key[2],
                out_structure)
        return run(inputs, params)


def _one_copy_error(block, e):
    """The error a call of ``block`` raises for ``e``: an ``MXNetError``
    when ``e`` is torch's device mismatch and a parameter of ``block`` was
    initialised on more than one context (it keeps one copy, on the first,
    the JAX package's design, so an input on another card cannot meet it),
    else ``e`` itself. Only a failed call pays for the check."""
    if "same device" not in str(e):
        return e
    multi = [p for p in block.collect_params().values()
             if p._ctx_list and len(p._ctx_list) > 1]
    if not multi:
        return e
    p = multi[0]
    err = MXNetError(
        "%s: parameter %s was initialised on %s and keeps one copy, on %s, "
        "as the JAX package keeps it; an input on another device cannot "
        "meet it (keep the inputs on %s, or train over the contexts with a "
        "Module)" % (type(block).__name__, p.name, p._ctx_list,
                     p._ctx_list[0], p._ctx_list[0]))
    err.__cause__ = e
    return err


def _flatten(args):
    """The NDArray (or Symbol) leaves of ``args``, which may nest them in
    lists and tuples, and a hashable structure that rebuilds it (other
    values are kept in the structure as they are)."""
    from ..symbol.symbol import Symbol

    leaves = []

    def walk(a):
        if isinstance(a, (NDArray, Symbol)):
            leaves.append(a)
            return "*"
        if isinstance(a, (list, tuple)):
            return (type(a).__name__, tuple(walk(x) for x in a))
        return ("=", a)

    return leaves, tuple(walk(a) for a in args)


def _unflatten(leaves, structure):
    """``args`` rebuilt from :func:`_flatten`'s leaves and structure."""
    it = iter(leaves)

    def build(spec):
        if spec == "*":
            return next(it)
        kind, val = spec
        if kind == "=":
            return val
        items = [build(x) for x in val]
        return tuple(items) if kind == "tuple" else items

    return [build(spec) for spec in structure]


class _GraphCall:
    """One traced graph run on tensors: the inputs' and the parameters'
    (by name), with autograd on while recording; a training call's
    auxiliary-state updates are copied into the parameters. With
    ``out_structure`` the outputs come back nested as the forward
    returned them."""

    def __init__(self, graph, input_names, is_train, out_structure=None):
        from ..executor import _graph_closure

        self.input_names = input_names
        self.param_names = [n for n in graph.list_inputs()
                            if n not in input_names]
        self.fn = _graph_closure(graph, is_train)
        self.single = len(graph.list_outputs()) == 1
        self.out_structure = out_structure

    def __call__(self, inputs, params):
        values = dict(zip(self.input_names, (a.tensor for a in inputs)))
        for name in self.param_names:
            try:
                values[name] = params[name].data().tensor
            except KeyError:
                raise MXNetError("graph input %r is neither an input nor a "
                                 "parameter" % name) from None
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, aux_updates = self.fn(values)
        with torch.no_grad():
            for name, val in aux_updates.items():
                params[name].data().tensor.copy_(val)
        ctx = inputs[0].context if inputs else None
        outs = [NDArray(o, ctx) for o in outs]
        if self.out_structure is not None:
            return _unflatten(outs, self.out_structure)[0]
        return outs[0] if self.single else outs


class SymbolBlock(HybridBlock):
    """A graph (``outputs`` of ``inputs``) and its parameters as a block:
    every graph input that is not one of ``inputs`` is a parameter, set
    from ``params`` when it holds it."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        from .. import symbol as sym_mod

        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._input_names = [i.name for i in inputs]
        arg_params = params or {}
        for name in outputs.list_inputs():
            if name in self._input_names:
                continue
            p = Parameter(name, allow_deferred_init=True)
            if name in arg_params:
                p.shape = arg_params[name].shape
                p.initialize()
                p.set_data(arg_params[name])
            self.params._params[name] = p
        self._out_symbol = outputs

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of an exported graph and its ``.params`` file
        (``arg:``/``aux:`` prefixes dropped)."""
        from .. import symbol as sym_mod
        from ..ndarray.utils import load as nd_load

        outputs = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [sym_mod.var(n) for n in input_names]
        params = {}
        if param_file is not None:
            for k, v in nd_load(param_file).items():
                params[k.split(":", 1)[1] if ":" in k else k] = v
        return SymbolBlock(outputs, inputs, params=params)

    def _call_cached(self, args):
        return self.forward(*args)

    def forward(self, *args):
        key = autograd.is_training()
        run = self._cached.get(key)
        if run is None:
            run = self._cached[key] = _GraphCall(self._out_symbol,
                                                 self._input_names, key)
        return run(list(args), dict(self.params.items()))
